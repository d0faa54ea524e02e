"""ENet, the 2D CNN of the multiview path (port of
``situation3d_tpu/models/enet.py``): the encoder-only ENet the reference
uses (initial block, stage 1 at 64 channels, stages 2 and 3 at 128, a
bias-free 1x1 classifier), split as ``create_enet_for_3d`` splits it into a
frozen trunk (``fixed``), a trainable stage 3 (``trainable``) and the
classifier; ``enet_trainable_paths`` is the predicate for
``train/optim.py:mask_from_predicate``.

Images go in and features come out as NHWC, as in the reference. Inside,
each conv reads its NHWC input as a channels-last NCHW view, so nothing is
copied between layers. Submodule names follow the reference's parameter tree
(``Conv_0``, ``BatchNorm_1``, ``PReLU_2``, ...). Conventions kept from it:

- ``padding="SAME"`` is the reference's: ``ceil(n / s)`` outputs, the total
  padding split with the smaller half in front, so a 3x3 or 2x2 stride-2
  conv pads (0, 1) where the size needs one; max pooling pads with -inf;
- conv kernels keep the reference's HWIO layout (read as OIHW);
- batch norms are flax's (``models/layers.py:BatchNorm``: momentum 0.99,
  the biased ``E[x^2] - E[x]^2`` variance);
- ``PReLU`` has one slope, initialized to 0.01; dropout is element-wise.

``ENetForMultiview`` is built on its device (the card unless the caller
passes the CPU) with seeded weights, as the other models of the port are.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.models.layers import BatchNorm, dropout, materialise


def _same_pads(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
               dilation: Sequence[int] = (1, 1)) -> Tuple[int, ...]:
    """``F.pad`` widths of an NHWC tensor for SAME padding over H and W."""
    pads = []
    for n, k, s, d in zip(x.shape[1:3], kernel, stride, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    (h0, h1), (w0, w1) = pads
    return (0, 0, w0, w1, h0, h1)


class Conv(nn.Module):
    """2-D conv with SAME padding on NHWC tensors; ``kernel`` keeps the
    reference's HWIO layout and is read as OIHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Sequence[int],
                 stride: int = 1, dilation: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = tuple(kernel), stride, dilation
        self.kernel = nn.Parameter(torch.empty(*kernel, in_channels, out_channels))
        nn.init.normal_(self.kernel, std=1.0 / math.sqrt(in_channels * math.prod(kernel)))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, d = (self.stride,) * 2, (self.dilation,) * 2
        x = F.pad(x, _same_pads(x, self.kernel_size, s, d))
        w = self.kernel.permute(3, 2, 0, 1).to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w,
                     None if self.bias is None else self.bias.to(x.dtype), s, 0, d)
        return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pooling of NHWC with SAME padding (-inf pads)."""
    x = F.pad(x, _same_pads(x, (2, 2), (2, 2)), value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """``x`` where ``x >= 0``, else ``negative_slope * x``; one slope."""

    def __init__(self, init: float = 0.01):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


class InitialBlock(nn.Module):
    """Stride-2 3x3 conv beside a 2x2 max pool, concatenated, BN, PReLU."""

    def __init__(self, in_channels: int = 3, out_channels: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels - in_channels, (3, 3), 2,
                           use_bias=False)
        self.BatchNorm_0 = BatchNorm(out_channels, dtype=dtype)
        self.PReLU_0 = PReLU()

    def forward(self, x, train: bool = False):
        out = torch.cat([self.Conv_0(x), max_pool_same(x)], dim=-1)
        return self.PReLU_0(self.BatchNorm_0(out, train))


class Bottleneck(nn.Module):
    """1x1 (2x2 stride 2 when downsampling) projection -> main conv (3x3,
    dilated 3x3, or (1,5) then (5,1)) -> 1x1 expansion, BN + PReLU between,
    dropout, then PReLU of the sum with the residual (max-pooled when
    downsampling, zero-padded on the channels). Projections have no bias; the
    main conv has one (the (5,1) half of the asymmetric pair)."""

    def __init__(self, in_channels: int, out_channels: int, internal_ratio: int = 4,
                 downsample: bool = False, dilation: int = 1, asymmetric: bool = False,
                 pdrop: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        internal = out_channels // internal_ratio
        self.out_channels, self.downsample, self.pdrop = out_channels, downsample, pdrop
        k = (2, 2) if downsample else (1, 1)
        convs = [Conv(in_channels, internal, k, 2 if downsample else 1, use_bias=False)]
        if asymmetric:
            convs += [Conv(internal, internal, (1, 5), use_bias=False),
                      Conv(internal, internal, (5, 1))]
        else:
            convs.append(Conv(internal, internal, (3, 3), dilation=dilation))
        convs.append(Conv(internal, out_channels, (1, 1), use_bias=False))
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
        self.n_convs = len(convs)
        for i, c in enumerate((internal, internal, out_channels)):
            self.add_module(f"BatchNorm_{i}", BatchNorm(c, dtype=dtype))
            self.add_module(f"PReLU_{i}", PReLU())

    def forward(self, x, train: bool = False, generator=None):
        h = self.PReLU_0(self.BatchNorm_0(self.Conv_0(x), train))
        for i in range(1, self.n_convs - 1):
            h = getattr(self, f"Conv_{i}")(h)
        h = self.PReLU_1(self.BatchNorm_1(h, train))
        h = self.BatchNorm_2(getattr(self, f"Conv_{self.n_convs - 1}")(h), train)
        h = dropout(h, self.pdrop, train, generator)
        residual = max_pool_same(x) if self.downsample else x
        if residual.shape[-1] != self.out_channels:
            residual = F.pad(residual, (0, self.out_channels - residual.shape[-1]))
        return self.PReLU_2(h + residual)


# the repeated 8-bottleneck spec of stages 2 and 3: regular, dilation 2,
# asymmetric 5, dilation 4, regular, dilation 8, asymmetric 5, dilation 16
_STAGE_SPECS = [dict(), dict(dilation=2), dict(asymmetric=True),
                dict(dilation=4), dict(), dict(dilation=8),
                dict(asymmetric=True), dict(dilation=16)]


class _Stack(nn.Module):
    def forward(self, x, train: bool = False, generator=None):
        for m in self.children():
            x = m(x, train, generator) if isinstance(m, Bottleneck) else m(x, train)
        return x


class ENetStage12(_Stack):
    """Initial block + stage 1 (@64) + stage 2 (@128): the frozen trunk."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.initial = InitialBlock(3, 16, dtype)
        self.bottleneck1_0 = Bottleneck(16, 64, downsample=True, pdrop=0.01, dtype=dtype)
        for i in range(4):
            self.add_module(f"bottleneck1_{i + 1}", Bottleneck(64, 64, pdrop=0.01, dtype=dtype))
        self.bottleneck2_0 = Bottleneck(64, 128, downsample=True, dtype=dtype)
        for i, kw in enumerate(_STAGE_SPECS):
            self.add_module(f"bottleneck2_{i + 1}", Bottleneck(128, 128, dtype=dtype, **kw))


class ENetStage3(_Stack):
    """Stage 3: the 8-spec pattern again at 128 channels, no downsample."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, kw in enumerate(_STAGE_SPECS):
            self.add_module(f"bottleneck3_{i}", Bottleneck(128, 128, dtype=dtype, **kw))


class ENetEncoder(nn.Module):
    """The whole trunk: ``[B, H, W, 3]`` -> ``[B, H/8, W/8, 128]``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage12 = ENetStage12(dtype)
        self.stage3 = ENetStage3(dtype)

    def forward(self, x, train: bool = False, generator=None):
        return self.stage3(self.stage12(x, train, generator), train, generator)


@torch.no_grad()
def init_enet_weights(model: nn.Module, seed: int) -> None:
    """The reference's initial values, conv kernels drawn from ``seed`` on
    the model's device in module order: kernels ``N(0, 1 / fan_in)``, conv
    biases 0, batch norms the identity (scale 1, bias 0, mean 0, var 1),
    ``PReLU`` slopes 0.01."""
    g = None
    for m in model.modules():
        if isinstance(m, Conv):
            if g is None:
                g = torch.Generator(device=m.kernel.device).manual_seed(seed)
            m.kernel.normal_(0.0, 1.0 / math.sqrt(m.kernel.shape[:-1].numel()), generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.scale.fill_(1.0), m.bias.zero_(), m.mean.zero_(), m.var.fill_(1.0)
        elif isinstance(m, PReLU):
            m.negative_slope.fill_(0.01)


class ENetForMultiview(nn.Module):
    """Frozen trunk (``fixed``), trainable stage 3 (``trainable``) and the
    bias-free 1x1 ``classifier``. Returns ``(feats [B, H/8, W/8, 128],
    logits [B, H/8, W/8, num_classes])``. ``train`` puts the batch norms in
    training form and turns on dropout, its masks drawn from ``generator``.
    Built on ``device`` (default ``"cuda"``, which raises without a card)
    with ``init_enet_weights(seed)``, in evaluation mode."""

    def __init__(self, num_classes: int = 41, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        with torch.device("meta"):
            self.fixed = ENetStage12(dtype)
            self.trainable = ENetStage3(dtype)
            self.classifier = Conv(128, num_classes, (1, 1), use_bias=False)
        materialise(self, device, seed, init_enet_weights)

    def forward(self, x, train: bool = False, generator=None):
        feats = self.trainable(self.fixed(x, train, generator), train, generator)
        return feats, self.classifier(feats)


def enet_trainable_paths(path: Tuple[str, ...]) -> bool:
    """Path predicate for ``train/optim.py`` masks: stage 3 and the
    classifier train, the ``fixed`` trunk does not."""
    return not (path and path[0] == "fixed")
