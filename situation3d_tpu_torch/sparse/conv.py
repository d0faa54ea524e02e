"""Sparse convolution compute + normalization modules (port of
``situation3d_tpu/sparse/conv.py``: ``sparse_conv_apply`` with its
gather-only backward, ``SparseConv``, ``SparseConv1x1``, ``SparseBatchNorm``,
``sparse_relu``).

A sparse conv is a sum over kernel offsets of ``gather -> matmul`` over a
precomputed neighbor map; every map-driven conv goes through
``ops/cuda/fused_conv.py`` (CUDA kernel on the card, its plain version on
the CPU), forward and ``dx``; ``dW`` gathers ``dy`` rows through
``ops/cuda/gather_rows.py`` and reduces with one large product. Parameters
keep the reference's names and layouts (conv kernels ``[K, C_in, C_out]``)
and are float32; ``dtype`` is the compute dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from situation3d_tpu_torch.ops.cuda.fused_conv import fused_sparse_conv
from situation3d_tpu_torch.ops.cuda.gather_rows import gather_rows
from situation3d_tpu_torch.parallel.collectives import psum_differentiable
from situation3d_tpu_torch.sparse.tensor import SparseVoxels

# the gathered rows of one dW chunk stay under this many bytes (conv0's 125
# offsets x 49152 voxels x 8 samples of 32 bf16 would be 3.1 GB whole)
GATHER_CHUNK_BYTES = 1 << 30


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) accumulated and returned in float32. bfloat16 products
    are exact in float32, so upcasting (on the CPU, or where autograd must
    differentiate the product, which ``torch.mm(..., out_dtype=)`` does not
    support) is the same arithmetic as the card's bf16-in, f32-out product."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _offset_chunks(K: int, bytes_per_offset: int):
    per = max(1, GATHER_CHUNK_BYTES // max(bytes_per_offset, 1))
    n = -(-K // per)
    per = -(-K // n)
    return [(j, min(j + per, K)) for j in range(0, K, per)]


def _weight_grad(rows: torch.Tensor, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``sum_{b,u} rows[b,u]^T (x) table[b, idx[b,u,j]]`` for every map
    column ``j``: float32 ``[K, C_rows, C_table]``. ``idx`` entries outside
    the table read a zero row. One ``gather_rows`` launch serves a chunk of
    offsets (voxel-major, so the gathered block is the right operand of ONE
    product over all (sample, voxel) pairs)."""
    if (table.shape[2] * table.element_size()) % 4:
        # an odd number of bf16 channels: gather_rows moves 4-byte words
        rows, table = rows.float(), table.float()
    B, U, C_r = rows.shape
    V, C_t = table.shape[1], table.shape[2]
    K = idx.shape[2]
    padded = torch.cat([table, table.new_zeros(B, 1, C_t)], dim=1)
    safe = torch.where((idx >= 0) & (idx < V), idx, V)
    lhs = rows.reshape(B * U, C_r).t()                          # [C_r, B*U]
    out = []
    for j0, j1 in _offset_chunks(K, B * U * C_t * table.element_size()):
        nk = j1 - j0
        g = gather_rows(padded, safe[:, :, j0:j1].reshape(B, U * nk))
        prod = _matmul_f32(lhs, g.view(B * U, nk * C_t))        # [C_r, nk*C_t]
        out.append(prod.view(C_r, nk, C_t).permute(1, 0, 2))
    return torch.cat(out, dim=0)


class _SparseConvTmap(torch.autograd.Function):
    """The fused conv with the reference's gather-only backward
    (``_sparse_conv_tmap``): ``t_map [B, V_in, K]`` is the transpose of
    ``nbr_idx``, ``t_map(u, j) = v  <=>  nbr_idx(v, g(j)) = u`` with
    ``g(j) = K-1-j`` when ``flip_kernel`` (same-coords centered odd kernels:
    the map is its own transpose under offset reversal) and ``g(j) = j``
    otherwise (the k2 pairs ``map_down`` / ``map_up``).

      dx[u]    = sum_j dy[t_map(u, j)] @ W[g(j)]^T    the forward kernel on
                                                      the transpose map
      dW[g(j)] = sum_u feats[u]^T dy[t_map(u, j)]     gather_rows + a product

    No scatter, no atomics: deterministic. Padding voxels have all-miss
    ``t_map`` rows (``dx = 0``) and zero ``feats`` rows (nothing enters
    ``dW``); the caller masks ``dy`` (the mask multiply sits outside).
    """

    @staticmethod
    def forward(ctx, feats, nbr_idx, t_map, kernel, flip_kernel):
        ctx.save_for_backward(feats, t_map, kernel)
        ctx.flip_kernel = flip_kernel
        return fused_sparse_conv(feats, nbr_idx, kernel).to(feats.dtype)

    @staticmethod
    def backward(ctx, dy):
        feats, t_map, kernel = ctx.saved_tensors
        dy = dy.to(feats.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = kernel.flip(0) if ctx.flip_kernel else kernel
            dx = fused_sparse_conv(dy, t_map, wt.transpose(1, 2)).to(feats.dtype)
        if ctx.needs_input_grad[3]:
            dw = _weight_grad(feats, dy, t_map)
            if ctx.flip_kernel:
                dw = dw.flip(0)
            dw = dw.to(kernel.dtype)
        return dx, None, None, dw, None


def sparse_conv_apply(feats: torch.Tensor, nbr_idx: torch.Tensor,
                      kernel: torch.Tensor, symmetric_bwd: bool = False,
                      transpose_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather-matmul sparse convolution.

    Args:
      feats:   [B, V_in, C_in] input features (padding rows must be zero).
      nbr_idx: int32 [B, V_out, K] neighbor map (misses, ``V_in`` or ``-1``,
        gather zeros).
      kernel:  [K, C_in, C_out] weights.
      symmetric_bwd: gather-only backward for SAME-COORDS odd-cube-kernel
        convs (the UNet's k3/k5 stride-1 convs), where the map is its own
        transpose under offset reversal.
      transpose_map: explicit transpose map [B, V_in, K] for strided convs
        (the k2 down convs pass the level's ``map_up``); same backward, no
        kernel-index flip. Mutually exclusive with ``symmetric_bwd``.
    One of the two is required: the backward runs on it.
    Returns [B, V_out, C_out] (float32 accumulated, cast back to feats.dtype).
    """
    if transpose_map is not None:
        return _SparseConvTmap.apply(feats, nbr_idx, transpose_map, kernel, False)
    if symmetric_bwd:
        return _SparseConvTmap.apply(feats, nbr_idx, nbr_idx, kernel, True)
    raise ValueError("sparse_conv_apply: the backward needs symmetric_bwd=True "
                     "or a transpose_map; neither was given")


def _fan_in_normal_(w: torch.Tensor, fan_in: int) -> None:
    """He-style fan-in init: normal truncated at two standard deviations,
    rescaled so the truncated distribution has variance ``2 / fan_in``."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class SparseConv(nn.Module):
    """Sparse convolution over a precomputed neighbor map (bias-free; BN
    supplies the bias). The direction (down, same, transpose) lives entirely
    in the map; the backward runs on ``symmetric_bwd`` or the call's
    ``transpose_map``, and a call with neither raises."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int,
                 dtype: torch.dtype = torch.float32, symmetric_bwd: bool = False):
        super().__init__()
        self.dtype = dtype
        self.symmetric_bwd = symmetric_bwd
        self.kernel = nn.Parameter(torch.empty(kernel_volume, in_channels, out_channels))
        _fan_in_normal_(self.kernel, kernel_volume * in_channels)

    def forward(self, x: SparseVoxels, nbr_idx, out_coords, out_mask,
                out_stride, transpose_map=None) -> SparseVoxels:
        out = sparse_conv_apply(x.feats.to(self.dtype), nbr_idx, self.kernel,
                                symmetric_bwd=self.symmetric_bwd,
                                transpose_map=transpose_map)
        out = out * out_mask[..., None]
        return SparseVoxels(coords=out_coords, feats=out, mask=out_mask,
                            stride=out_stride)


class SparseConv1x1(nn.Module):
    """kernel_size=1 sparse conv == per-voxel dense projection (BasicBlock
    downsample path; with ``use_bias``, the UNet's ``final`` head). A plain
    large product: left to ``torch.matmul``."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, use_bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels))
        _fan_in_normal_(self.kernel, in_channels)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: SparseVoxels) -> SparseVoxels:
        feats, w = x.feats.to(self.dtype), self.kernel.to(self.dtype)
        if self.bias is None:
            out = torch.matmul(feats, w)
        else:   # as the reference: f32 product plus bias, then the cast
            out = _matmul_f32(feats.reshape(-1, feats.shape[-1]), w)
            out = (out.view(*feats.shape[:-1], -1) + self.bias).to(self.dtype)
        return x.replace(feats=out * x.mask[..., None])


class SparseBatchNorm(nn.Module):
    """Masked batch norm over valid voxels (``ME.MinkowskiBatchNorm``):
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32, masked rows
    zeroed, then cast.

    Evaluation form (``use_running_average``): the running statistics.
    Training form: the float32 statistics of every valid voxel of the whole
    batch, ``n = max(sum(mask), 1)``, ``mean = sum(f * m) / n`` and the
    two-pass biased variance ``sum((f - mean)^2 * m) / n``; gradients flow
    through them. Under a process group of more than one process the sums
    run over the global batch (one all-reduce of the sums and the count, then
    one of the squared deviations), as the reference's pjit takes them. The
    running statistics then move by ``ra = mom * ra + (1 - mom) * batch``
    with ``mom`` the call's ``momentum`` (``MOMENTUM`` without one): the
    reference's convention, the reverse of ``torch.nn.BatchNorm``'s, whose
    running variance is moreover the unbiased one.
    """
    MOMENTUM = 0.9

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: SparseVoxels, use_running_average: bool = True,
                momentum: Optional[float] = None) -> SparseVoxels:
        f = x.feats.float()
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            m = x.mask[..., None].float()
            C = f.shape[-1]
            sums = psum_differentiable(torch.cat([(f * m).sum(dim=(0, 1)), m.sum()[None]]))
            n = sums[C].detach().clamp(min=1.0)
            mean = sums[:C] / n
            var = psum_differentiable(((f - mean).square() * m).sum(dim=(0, 1))) / n
            mom = self.MOMENTUM if momentum is None else momentum
            with torch.no_grad():
                self.mean.mul_(mom).add_((1.0 - mom) * mean)
                self.var.mul_(mom).add_((1.0 - mom) * var)
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        out = (f - mean) * inv + self.bias
        return x.replace(feats=(out * x.mask[..., None]).to(self.dtype))


def sparse_relu(x: SparseVoxels) -> SparseVoxels:
    return x.replace(feats=torch.relu(x.feats))
