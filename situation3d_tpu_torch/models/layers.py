"""Dense / embedding / layer-norm / batch-norm layers with float32 parameters
and a separate compute dtype, the convention of the reference's layers: inputs
and parameters are cast to ``dtype`` for the product, normalization statistics
are taken in float32. A :class:`Dense` that no gradient reaches reads its
weight from a copy in ``dtype`` made once, not cast at every call.
``dropout`` draws its mask from an explicit ``torch.Generator`` (``F.dropout``
takes none)."""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.parallel.mesh import draw


weight_copies = 0   # +1 per compute-dtype copy of a Dense's weight made or refreshed


class ComputeCopy:
    """A :class:`Dense`'s weight and bias in its compute dtype, and the key
    of the masters it was taken from: their storage and version counters.
    Not the module's state: a copy or a pickle of the module holds an empty
    one."""

    def __init__(self):
        self.key, self.weight, self.bias = None, None, None

    def __reduce__(self):
        return type(self), ()


def _refreshed(copy: Optional[torch.Tensor], master: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``master`` in ``dtype``: the master itself where it is held in
    ``dtype``, written into ``copy`` where that has the master's shape and
    device (its address kept), else a new tensor."""
    if master.dtype == dtype:
        return master
    if (copy is not None and copy.shape == master.shape and copy.dtype == dtype
            and copy.device == master.device):
        return copy.copy_(master)
    return master.to(dtype)


class Dense(nn.Linear):
    """``F.linear`` in ``dtype`` on parameters of their own dtype. Where no
    gradient reaches the weight (grad mode off, or the weight frozen) and it
    is not held in ``dtype``, the product reads a copy in ``dtype`` kept on
    the module (:meth:`compute_operands`): the values of the per-call cast,
    made once and refreshed in place when the master changes. Otherwise the
    weight and bias are cast at every call."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype
        self.compute_copy = ComputeCopy()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        operands = self.compute_operands() if self.reads_copy() else None
        if operands is None:
            operands = (self.weight.to(self.dtype),
                        None if self.bias is None else self.bias.to(self.dtype))
        return F.linear(x.to(self.dtype), *operands)

    def reads_copy(self) -> bool:
        """Whether this call reads the compute-dtype copy: the weight is held
        in another dtype and no gradient reaches it. An inference tensor
        counts no versions, so its changes cannot be seen: it is cast."""
        w = self.weight
        return (w.dtype != self.dtype and not (w.requires_grad and torch.is_grad_enabled())
                and not w.is_inference())

    def compute_operands(self) -> Optional[tuple]:
        """The weight and bias from the copy, made or refreshed first where
        a master's storage or version moved since; None while a stream
        captures and the copy is stale (the cast is captured instead). The
        copy is made outside inference mode, so that a later forward with
        grad on may save it for its backward."""
        global weight_copies
        c, w, b = self.compute_copy, self.weight, self.bias
        key = (w.data_ptr(), w._version) + (() if b is None else (b.data_ptr(), b._version))
        if c.key != key:
            if w.is_cuda and torch.cuda.is_current_stream_capturing():
                return None
            with torch.no_grad(), torch.inference_mode(False):
                c.weight = _refreshed(c.weight, w, self.dtype)
                c.bias = None if b is None else _refreshed(c.bias, b, self.dtype)
            c.key = key
            weight_copies += 1
        return c.weight, c.bias


def refresh_copies(layers: Iterable[Dense]) -> None:
    """Make or refresh every copy that ``layers`` read now, outside any
    capture: a replayed graph reads the copies through their addresses, and
    no Python runs inside it to see a master change."""
    for d in layers:
        if d.reads_copy():
            d.compute_operands()


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


def materialise(module: nn.Module, device, seed: int,
                init: Callable[[nn.Module, int], None] = init_blip2_weights) -> None:
    """Place a model built on ``meta`` on ``device`` and fill it with
    ``init(module, seed)`` (``init_blip2_weights`` unless told otherwise; an
    ``init`` must fill the buffers too); ``device="meta"`` leaves it for the
    parent that builds it into a larger model."""
    dev = resolve_device(device)
    if dev.type != "meta":
        module.to_empty(device=dev)
        init(module, seed)
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
