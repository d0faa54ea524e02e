"""Dense / embedding / layer-norm layers with float32 parameters and a
separate compute dtype, the convention of the reference's layers: inputs and
parameters are cast to ``dtype`` for the product, normalization statistics
are taken in float32. ``dropout`` draws its mask from an explicit
``torch.Generator`` (``F.dropout`` takes none)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class Embed(nn.Embedding):
    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, features)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class LayerNorm(nn.LayerNorm):
    def __init__(self, features: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: in training each element is kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)``; the identity otherwise. The mask
    is drawn where ``generator`` lives (on ``x``'s device without one), so
    one seeded generator reproduces a step."""
    if not train or p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    where = generator.device if generator is not None else x.device
    keep = torch.rand(x.shape, generator=generator, device=where) >= p
    return x * keep.to(x.device) * (1.0 / (1.0 - p))
