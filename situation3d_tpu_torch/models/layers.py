"""Dense / embedding / layer-norm / batch-norm layers with float32 parameters
and a separate compute dtype, the convention of the reference's layers: inputs
and parameters are cast to ``dtype`` for the product, normalization statistics
are taken in float32. ``dropout`` draws its mask from an explicit
``torch.Generator`` (``F.dropout`` takes none)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.parallel.mesh import draw


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


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


class BatchNorm(nn.Module):
    """Batch norm over every axis but the last, with the reference's
    conventions (flax ``nn.BatchNorm``): in evaluation form the running
    statistics normalize; in training form the batch's mean and BIASED
    variance (``E[x^2] - E[x]^2``, clamped at 0) normalize and move the
    running statistics, ``running = momentum * running + (1 - momentum) *
    batch`` (the biased variance there too). Statistics in float32."""

    def __init__(self, channels: int, momentum: float = 0.99, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = ((x * x).mean(axes) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        out = (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return out.to(self.dtype)


def init_random_weights(model: nn.Module, seed: int,
                        std: Optional[float] = 0.02) -> None:
    """Fill a model with random weights from ``torch.Generator(seed)``, in
    ``named_parameters`` order: conv kernels with the fan-in rule, other
    matrices ``N(0, std)`` (``std=None``: ``N(0, 1 / fan_in)``, which keeps
    activations of order one through a stack without layer norms), scales 1,
    biases 0; batch-norm running variance in [0.5, 1.5] and mean
    ``N(0, 0.1)``. For smoke runs and benchmarks."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                fan_in = p.shape[0] if p.dim() == 2 else p.shape[0] * p.shape[1]
                v = torch.randn(p.shape, generator=g) * math.sqrt(2.0 / fan_in)
            elif p.dim() >= 2:
                v = torch.randn(p.shape, generator=g) * (
                    std if std is not None else 1.0 / math.sqrt(p.shape[-1]))
            elif leaf in ("scale",) or (leaf == "weight" and p.dim() == 1):
                v = torch.ones(p.shape)
            else:
                v = torch.zeros(p.shape)
            p.copy_(v)
        for name, buf in model.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "var":
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
            elif leaf == "mean":
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))


@torch.no_grad()
def init_blip2_weights(model: nn.Module, seed: int, std: float = 0.02) -> None:
    """Seeded random weights drawn on the model's device, in
    ``named_parameters`` order: matrices and query tokens ``N(0, std)``,
    norm weights 1, biases 0. For smoke runs and benchmarks."""
    g = None
    for name, p in model.named_parameters():
        if g is None:
            g = torch.Generator(device=p.device).manual_seed(seed)
        if p.dim() >= 2:
            p.normal_(0.0, std, generator=g)
        elif name.rsplit(".", 1)[-1] == "bias":
            p.zero_()
        else:
            p.fill_(1.0)


def materialise(module: nn.Module, device, seed: int) -> None:
    """Place a model built on ``meta`` on ``device`` and fill it with
    ``init_blip2_weights(seed)``; ``device="meta"`` leaves it for the parent
    that builds it into a larger model."""
    dev = resolve_device(device)
    if dev.type != "meta":
        module.to_empty(device=dev)
        init_blip2_weights(module, seed)
        module.eval()


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: in training each element is kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)``; the identity otherwise. The mask
    is drawn where ``generator`` lives (on ``x``'s device without one), so
    one seeded generator reproduces a step; a ``ShardedGenerator`` gives the
    rank's rows of the global batch's mask."""
    if not train or p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    where = generator.device if generator is not None else x.device
    keep = draw(torch.rand, x.shape, generator=generator, device=where) >= p
    return x * keep.to(x.device) * (1.0 / (1.0 - p))
