"""Fused sparse convolution (gather + miss mask + per-offset product, f32
sum): CUDA kernel + plain version.

Source note. Replaces the TPU kernel ``situation3d_tpu/ops/pallas/
fused_conv.py`` (``_fused_kernel`` / ``fused_sparse_conv``). The same kernel
serves the backward: ``sparse/conv.py`` runs it on the transpose map with
transposed weights for ``dx``, so the weights are detached here and the
``autograd.Function`` there owns the graph. On an H100 the k3 convs at wide
channels are bound by operations and conv0 / the k2 convs by the map and
output bytes (``chip_smoke.py`` works the bound out per shape). The design
(``csrc/fused_conv.cu``) treats the sum over offsets and channels as one
contraction of length ``K*C_in`` whose left operand is gathered: a block
owns a tile of output voxels of one sample, loops over the contraction
inside the block, stages gathered rows and weights in shared memory,
accumulates in f32 registers, and skips chunks in which every entry is a
miss. bfloat16 inputs with ``C_in % 32 == 0``, ``C_out % 8 == 0``, ``K <= 32`` (every
k2 / k3 conv of the UNet) multiply on the tensor cores (``mma.sync`` through
the wmma API, f32 accumulators); any other shape, conv0's ``C_in = 3`` and
float32 included, takes the CUDA-core kernel. wgmma, TMA and cp.async
pipelines are later work. The TPU kernel's
packed 128-lane table rows, lane-select masks and (B, block, K) sequential
grid have no counterpart here.
"""
from __future__ import annotations

import torch

from situation3d_tpu_torch.ops.cuda import _build

launches = 0   # +1 per kernel launch, nowhere else


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
    feats, nbr_idx = feats.contiguous(), nbr_idx.contiguous()
    w = kernel.detach().to(feats.dtype).contiguous()
    out = torch.empty(B, V_out, C_out, dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        code = lib.s3d_fused_sparse_conv(
            feats.data_ptr(), nbr_idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            B, V_in, V_out, K, C_in, C_out, int(feats.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "fused_sparse_conv")
    launches += 1
    return out
