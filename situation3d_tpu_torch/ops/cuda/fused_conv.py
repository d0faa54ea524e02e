"""Fused sparse convolution (gather + miss mask + per-offset product, f32
sum): CUDA kernels + plain version.

Source note. Replaces the TPU kernel ``situation3d_tpu/ops/pallas/
fused_conv.py`` (``_fused_kernel`` / ``fused_sparse_conv``). The same kernels
serve the backward: ``sparse/conv.py`` runs them on the transpose map with
transposed weights for ``dx``, so the weights are detached here and the
``autograd.Function`` there owns the graph. The sum over offsets and
channels is one contraction of length ``K*C_in`` whose left operand is
gathered; each output element is summed by one thread in a fixed order, so
results are bit-reproducible. ``conv_route`` picks one of three kernels of
``csrc/fused_conv.cu`` (one launch a call):

  wgmma   bf16, ``C_in % 32 == 0``, ``C_out % 8 == 0``, ``C_out <= 256``,
          ``K <= 32``: every k2 / k3 / transposed conv of the UNet. A
          gathered-A GEMM: 128 output voxels x all of ``C_out`` a block,
          cp.async gathers into a swizzled 3-stage ring, W^T by TMA,
          ``wgmma`` with f32 accumulators; offsets that hit no voxel of a
          tile are skipped. Its bound on an H100: the f32 output bytes at
          levels 0-2, the tensor cores at levels 3-4; what holds it back
          is the rate at which the gathers issue.
  stream  ``C_in <= 4``, ``C_out <= 32``, ``K <= 128`` (conv0, bf16 or f32):
          bound by the map's bytes; map tiles stream into shared memory by
          bulk copies, hits are compacted with ballots, one lane an output
          channel on the CUDA cores.
  fma     anything else (f32 at wide channels): f32 FMAs on the CUDA cores.

The TPU kernel's packed 128-lane table rows, lane-select masks and (B,
block, K) sequential grid have no counterpart here.
"""
from __future__ import annotations

import torch

from situation3d_tpu_torch.ops.cuda import _build

launches = 0   # +1 per kernel launch, nowhere else

ROUTES = {"fma": 0, "wgmma": 1, "stream": 2}   # csrc/fused_conv.cu's ROUTE_*
WG_BM = 128        # output voxels a block of the wgmma kernel
WG_MAXK = 32       # map columns its tile keeps in shared memory
ST_MAXK = 128      # map columns the stream kernel takes


def conv_route(dtype: torch.dtype, K: int, C_in: int, C_out: int) -> str:
    """The kernel ``fused_sparse_conv`` launches for these shapes."""
    if C_in <= 4 and C_out <= 32 and K <= ST_MAXK:
        return "stream"
    if (dtype == torch.bfloat16 and C_in % 32 == 0 and C_out % 8 == 0
            and C_out <= 256 and K <= WG_MAXK):
        return "wgmma"
    return "fma"


def wgmma_bk(C_in: int) -> int:
    """Channels of one contraction step of the wgmma kernel: 64 (rows of
    128 bytes, 128-byte swizzle) where ``C_in % 64 == 0``, else 32 (64-byte
    rows and swizzle)."""
    return 64 if C_in % 64 == 0 else 32


def conv_instance(dtype: torch.dtype, K: int, C_in: int, C_out: int) -> str:
    """The kernel instance a call runs, for reports: the route and, for
    wgmma, its contraction step and padded column count."""
    route = conv_route(dtype, K, C_in, C_out)
    if route != "wgmma":
        return route
    return f"wgmma BK={wgmma_bk(C_in)} BN={-(-C_out // 32) * 32 if C_out <= 128 else 256}"


def fused_sparse_conv_plain(feats: torch.Tensor, nbr_idx: torch.Tensor,
                            kernel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_sparse_conv`: per offset one
    ``index_select`` from the zero-padded flat table and one matmul, summed
    in f32. Inputs are upcast first: products of bf16 values are exact in
    f32, so this is 'bf16 inputs, f32 accumulation'."""
    B, V_in, C_in = feats.shape
    V_out, K = nbr_idx.shape[1], nbr_idx.shape[2]
    w = kernel.to(feats.dtype).float()
    table = torch.cat([feats.float(), feats.new_zeros(B, 1, C_in, dtype=torch.float32)],
                      dim=1).view(B * (V_in + 1), C_in)
    idx = nbr_idx.to(torch.int64)
    idx = torch.where((idx < 0) | (idx >= V_in), V_in, idx)
    idx = idx + torch.arange(B, device=feats.device)[:, None, None] * (V_in + 1)
    out = torch.zeros(B * V_out, w.shape[-1], dtype=torch.float32, device=feats.device)
    for k in range(K):
        out += table.index_select(0, idx[:, :, k].reshape(-1)) @ w[k]
    return out.view(B, V_out, -1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it that starts on a 16-byte boundary (cp.async
    moves 16 bytes)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_sparse_conv(feats: torch.Tensor, nbr_idx: torch.Tensor,
                      kernel: torch.Tensor) -> torch.Tensor:
    """``out[b, v] = sum_k valid(idx[b,v,k]) * feats[b, idx[b,v,k]] @ W[k]``.

    Args:
      feats:   [B, V_in, C_in] float32 or bfloat16 (padding rows zero).
      nbr_idx: int32 [B, V_out, K]; entries outside [0, V_in) contribute 0
        (both the ``miss == V_in`` and the ``-1`` convention work).
      kernel:  [K, C_in, C_out]; cast to ``feats.dtype`` for the product.
    Returns [B, V_out, C_out] float32 (caller casts). CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise).
    """
    if feats.dim() != 3 or nbr_idx.dim() != 3 or kernel.dim() != 3:
        raise ValueError("fused_sparse_conv wants feats [B,V,C], idx [B,V,K], kernel [K,Ci,Co]")
    B, V_in, C_in = feats.shape
    V_out, K = nbr_idx.shape[1], nbr_idx.shape[2]
    if nbr_idx.shape[0] != B or kernel.shape[0] != K or kernel.shape[1] != C_in:
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, idx "
                         f"{tuple(nbr_idx.shape)}, kernel {tuple(kernel.shape)}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_sparse_conv takes float32 or bfloat16 feats, got {feats.dtype}")
    if nbr_idx.dtype != torch.int32:
        raise TypeError(f"fused_sparse_conv takes an int32 map, got {nbr_idx.dtype}")
    if not feats.is_cuda:
        return fused_sparse_conv_plain(feats, nbr_idx, kernel)
    if nbr_idx.device != feats.device or kernel.device != feats.device:
        raise ValueError("fused_sparse_conv: all tensors must be on one device")
    global launches
    lib = _build.load_library()
    C_out = kernel.shape[2]
    route = conv_route(feats.dtype, K, C_in, C_out)
    feats, nbr_idx = _aligned(feats.contiguous()), nbr_idx.contiguous()
    w = kernel.detach()
    if route == "wgmma":      # W^T [C_out, K*C_in]: the K-major operand TMA reads
        w = w.permute(2, 0, 1)
    # one copy casts (and for wgmma transposes) the weights
    w = torch.empty(w.shape, dtype=feats.dtype, device=feats.device).copy_(w)
    out = torch.empty(B, V_out, C_out, dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        code = lib.s3d_fused_sparse_conv(
            feats.data_ptr(), nbr_idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            B, V_in, V_out, K, C_in, C_out, int(feats.dtype == torch.bfloat16),
            ROUTES[route], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "fused_sparse_conv")
    launches += 1
    return out
