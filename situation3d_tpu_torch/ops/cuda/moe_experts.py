"""The expert layer of a sparse mixture of experts: each token's chosen
experts, each a SwiGLU ``w2(silu(w1 x) * w3 x)`` or, given no ``w3``, a
non-gated ``w2(relu(w1 x)^2)``, weighted by the router and summed. The CUDA
route and its plain version.

Replaces no TPU kernel: the JAX package holds no model with experts. It was
added for LFM2's 38 expert layers (``models/lfm2.py``), where the experts'
weights are about 90% of the bytes a greedy batch reads; Nemotron-H's 23
relu^2 expert layers (``models/nemotron_h.py``) take the non-gated form.

Bound on an H100: bytes. A decode step routes a few rows to each chosen
expert, so every chosen expert's 18.9 MB of bfloat16 weights is streamed
once for a handful of products a weight; a prefill's ~40 rows an expert
lie near the ridge. The design on the card, every step on the device and
no host read, so that a step can be captured in a CUDA graph:

1. ``segment_plan`` (``csrc/segment_plan.cu``, the kernel the sparse
   pooling and the detector's backward use) groups the (token, expert)
   assignments by expert, stable in assignment order; dropped assignments
   (expert -1: a padding token) take no segment;
2. two launches of the grouped kernel (``csrc/moe_experts.cu``), a block
   per (expert, column tile), a grid fixed by the shapes; a block of an empty
   segment exits at once. The first computes ``h = silu(w1 x) * w3 x`` (or
   ``relu(w1 x)^2``, a template form of the same kernel) of each segment
   row into a bfloat16 scratch, the second ``weight * w2 h`` into
   the row of the assignment, each from ``mma.sync`` products of bfloat16
   with float32 sums. A warp streams its weight rows once for up to 64 rows
   of the segment, in 16-byte loads that skip L1;
3. ``scatter_add_rows`` (``csrc/gather_rows.cu``) sums each token's rows in
   ascending assignment order, on a plan fixed by the shapes.

Counters: ``launches`` (host, +1 a call on the card), and on each device two
int64 counters added in place from the plan's offsets (:func:`count_routes`,
inside captured graphs too, apart from the kernels that run the segments):
the assignments routed and the (call, expert) pairs with at least one row.
:func:`device_counters` gives them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from situation3d_tpu_torch.ops.cuda import _build
from situation3d_tpu_torch.ops.cuda.gather_rows import scatter_add_rows, segment_plan

launches = 0     # +1 per expert layer run on the card (two grouped launches), nowhere else

_COUNTERS: Dict[str, torch.Tensor] = {}
_SUM_PLANS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def device_counters(device) -> torch.Tensor:
    """int64 [2] on ``device``: (rows routed, experts read), summed over every
    expert layer that ran there."""
    dev = torch.device(device)
    key = str(dev)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(2, dtype=torch.int64, device=dev)
    return _COUNTERS[key]


def _check(x, idx, weights, w1, w3, w2) -> None:
    N, D = x.shape
    E, M, D1 = w1.shape
    if (idx.dim() != 2 or idx.shape[0] != N or weights.shape != idx.shape or D1 != D
            or (w3 is not None and w3.shape != w1.shape) or tuple(w2.shape) != (E, D, M)):
        raise ValueError(f"moe_experts: x {tuple(x.shape)}, idx {tuple(idx.shape)}, weights "
                         f"{tuple(weights.shape)}, w1 {tuple(w1.shape)}, "
                         f"w3 {None if w3 is None else tuple(w3.shape)}, w2 {tuple(w2.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"moe_experts takes int32 expert ids, got {idx.dtype}")


def moe_experts_plain(x: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                      w1: torch.Tensor, w3: Optional[torch.Tensor], w2: torch.Tensor,
                      counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_experts`, the kernel's arithmetic:
    float32 products of the stored values, ``h`` rounded to ``x``'s dtype,
    each token's rows added in ascending order of its choices."""
    _check(x, idx, weights, w1, w3, w2)
    N, K = idx.shape
    rows = torch.zeros(N, K, x.shape[1], dtype=torch.float32, device=x.device)
    xf = x.float()
    read = 0
    for e in range(w1.shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        read += 1
        xe = xf[tok]
        if w3 is None:
            h = F.relu(xe @ w1[e].float().T).square().to(x.dtype).float()
        else:
            h = (F.silu(xe @ w1[e].float().T) * (xe @ w3[e].float().T)).to(x.dtype).float()
        rows[tok, slot] = (h @ w2[e].float().T) * weights[tok, slot, None].float()
    if counters is not None:
        counters[0] += int((idx >= 0).sum())
        counters[1] += read
    out = rows[:, 0]
    for k in range(1, K):
        out = out + rows[:, k]
    return out


def count_routes(offsets: torch.Tensor, counters: torch.Tensor) -> None:
    """Adds the rows that the plan's ``offsets`` [1, E + 1] route and its
    experts with at least one row to ``counters`` in place, on the device
    and without a host read."""
    counters[0].add_(offsets[0, -1])
    counters[1].add_((offsets[0, 1:] > offsets[0, :-1]).sum())


def _sum_plan(N: int, K: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plan that sums rows ``n*K .. n*K+K-1`` into row ``n`` in order."""
    key = (N, K, str(device))
    if key not in _SUM_PLANS:
        a = torch.arange(N * K, dtype=torch.int32, device=device)
        _SUM_PLANS[key] = ((a // K)[None], a[None],
                           torch.arange(0, N * K + 1, K, dtype=torch.int32, device=device)[None])
    return _SUM_PLANS[key]


def moe_experts(x: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                w1: torch.Tensor, w3: Optional[torch.Tensor], w2: torch.Tensor,
                counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[n] = sum_k weights[n, k] * w2[e](silu(w1[e] x[n]) * w3[e] x[n])``
    with ``e = idx[n, k]``, the k in ascending order; with ``w3`` None
    ``w2[e](relu(w1[e] x[n])^2)``.

    Args:
      x: [N, D] token rows (bfloat16 on the card).
      idx: int32 [N, K] chosen experts in ``[0, E)``; -1 drops the choice.
      weights: float32 [N, K] routing weights.
      w1, w3: [E, M, D] (w3 None: the relu^2 form); w2: [E, D, M], the
        experts this layer holds.
      counters: int64 [2] added to in place (rows routed, experts read).
    Returns float32 [N, D]. CPU tensors run the plain version; CUDA tensors
    launch the kernels (or raise).
    """
    if not x.is_cuda:
        return moe_experts_plain(x, idx, weights, w1, w3, w2, counters)
    _check(x, idx, weights, w1, w3, w2)
    for t, name in ((x, "x"), (w1, "w1"), (w3, "w3"), (w2, "w2")):
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"moe_experts on the card takes bfloat16 {name}, got {t.dtype}")
    global launches
    N, K = idx.shape
    E, M, D = w1.shape
    if D % 128 or M % 64:
        raise ValueError(f"moe_experts: D={D} must be a multiple of 128, M={M} of 64")
    perm, offsets = segment_plan(idx.reshape(1, N * K), E)
    x, w1, w2 = x.contiguous(), w1.contiguous(), w2.contiguous()
    weights = weights.float().contiguous()
    h = torch.empty(N * K, M, dtype=torch.bfloat16, device=x.device)
    rows = torch.zeros(N * K, D, dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if w3 is None:
            code = lib.s3d_moe_experts_relu2(
                x.data_ptr(), perm.data_ptr(), offsets.data_ptr(), weights.data_ptr(),
                w1.data_ptr(), w2.data_ptr(), h.data_ptr(), rows.data_ptr(),
                N, K, E, D, M, stream)
        else:
            code = lib.s3d_moe_experts(
                x.data_ptr(), perm.data_ptr(), offsets.data_ptr(), weights.data_ptr(),
                w1.data_ptr(), w3.contiguous().data_ptr(), w2.data_ptr(), h.data_ptr(),
                rows.data_ptr(), N, K, E, D, M, stream)
    _build.check_launch(code, "moe_experts")
    launches += 1
    if counters is not None:
        count_routes(offsets, counters)
    dest, order, starts = _sum_plan(N, K, x.device)
    return scatter_add_rows(rows[None], dest, N, (order, starts))[0]
