"""Row gather and its deterministic scatter-add: three CUDA kernels (the
gather, the scatter-add's segment plan, its sum), their plain versions, and
the two ``autograd.Function``s that make gather and scatter-add each the
other's backward.

Source note. Replaces the TPU kernel ``situation3d_tpu/ops/pallas/gather.py``
(``_gather_kernel`` / ``vmem_gather_rows``) and its backward ``_gather_bwd``
(a plain XLA scatter-add in the reference, kernels here). All three are bound
by bytes on an H100, and the scatter-add in practice by latency. The gather
(``csrc/gather_rows.cu``) moves 16-byte vectors, one a thread, rows in order,
the index word read once per row. The scatter-add adds no float atomics: its
plan (``csrc/segment_plan.cu``, a cluster of 8 blocks a sample: integer-atomic
counts, one scan, placement through cursors, each segment put in ascending
source order by rank; no library sort) lists each destination's source rows
in ascending order, and the sum (``csrc/gather_rows.cu``) walks them, one
warp a destination row (one thread for rows of under 8 channels), with up
to 8 rows' loads in flight, adding in that order, so two runs are bit-equal. The TPU kernel's
VMEM-resident table, f32-only rows, ``R % block_rows == 0`` and
``gather_fits_vmem`` have no counterpart here.

In the port the two carry (a) the dy-gather of the sparse conv's gather-only
backward (``sparse/conv.py``), (b) the token gather and the segment sums of
``models/sig3d.py:situated_token_pool`` with their gradients and (c) every
gather of the PointNet++ / VoteNet path with its backward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from situation3d_tpu_torch.ops.cuda import _build

gather_launches = 0    # +1 per gather kernel launch, nowhere else
scatter_launches = 0   # +1 per scatter-add (sum) kernel launch, nowhere else
plan_launches = 0      # +1 per segment-plan kernel launch, nowhere else

SegmentPlan = Tuple[torch.Tensor, torch.Tensor]


def _check(table: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    if table.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"{what} wants rows [B, n, C] and idx [B, R], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes float32 or bfloat16 rows, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{what} takes int32 indices, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"{what}: rows and indices must be on one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (a narrowed view may be neither)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# gather

def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_rows`: one ``index_select`` on
    the flat table. An index outside ``[0, V)`` raises here (on the CPU by a
    check, on the card by ``index_select``'s own assertion)."""
    B, V, C = table.shape
    if not idx.is_cuda and idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= V):
        raise IndexError(f"gather_rows: index outside [0, {V})")
    flat = idx.to(torch.int64) + torch.arange(B, device=idx.device)[:, None] * V
    return table.reshape(B * V, C).index_select(0, flat.reshape(-1)).view(B, -1, C)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, r, :] = table[b, idx[b, r], :]``.

    Args:
      table: [B, V, C] float32 or bfloat16; a row must be a multiple of 4 bytes.
      idx:   int32 [B, R] in ``[0, V)``. Anything else is the caller's fault:
        the plain version raises, the kernel writes a zero row.
    Returns [B, R, C] in the table's dtype. CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise).
    """
    _check(table, idx, "gather_rows")
    B, V, C = table.shape
    R = idx.shape[1]
    row_bytes = C * table.element_size()
    if row_bytes % 4:
        raise ValueError(f"gather_rows: a row of {C} x {table.dtype} is not a "
                         "multiple of 4 bytes")
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    global gather_launches
    lib = _build.load_library()
    table, idx = _aligned(table), idx.contiguous()
    out = torch.empty(B, R, C, dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        code = lib.s3d_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                   B, V, R, row_bytes,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "gather_rows")
    gather_launches += 1
    return out


# ---------------------------------------------------------------------------
# scatter-add

def sort_segments(idx: torch.Tensor, num_rows: int) -> SegmentPlan:
    """Plain version of :func:`segment_plan`: ``(perm int32 [B, R], offsets
    int32 [B, V+1])``. With ``key = idx`` where ``0 <= idx < V`` and ``V``
    elsewhere, ``perm`` is the stable argsort of each sample's keys and
    ``offsets[b, v]`` the first sorted position whose key is ``>= v``: the
    source rows of destination ``v`` are ``perm[b, offsets[b, v]:offsets[b,
    v+1]]`` in ascending order, and the dropped entries (indices outside
    ``[0, V)``) form the tail of ``perm``, also in ascending order."""
    key = torch.where((idx >= 0) & (idx < num_rows), idx, num_rows)
    sorted_key, perm = torch.sort(key, dim=1, stable=True)
    bounds = torch.arange(num_rows + 1, dtype=key.dtype, device=idx.device)
    offsets = torch.searchsorted(
        sorted_key, bounds.expand(idx.shape[0], num_rows + 1).contiguous(),
        out_int32=True)
    return perm.to(torch.int32), offsets


def segment_plan(idx: torch.Tensor, num_rows: int) -> SegmentPlan:
    """The scatter-add's bookkeeping, equal to :func:`sort_segments` (which
    says what it is). A plan can serve several sums over the same indices.

    Args:
      idx: int32 [B, R]; entries outside ``[0, num_rows)`` are dropped.
      num_rows: V, the number of destination rows.
    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise).
    """
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"segment_plan wants int32 idx [B, R], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not idx.is_cuda:
        return sort_segments(idx, num_rows)
    global plan_launches
    B, R = idx.shape
    V = int(num_rows)
    lib = _build.load_library()
    idx = idx.contiguous()
    perm = torch.empty(B, R, dtype=torch.int32, device=idx.device)
    offsets = torch.empty(B, V + 1, dtype=torch.int32, device=idx.device)
    scratch = torch.empty(B, R, dtype=torch.int32, device=idx.device)
    n_scratch = lib.s3d_segment_plan_scratch_ints(B, R, V)   # 0: all in shared memory
    counters = (torch.empty(n_scratch, dtype=torch.int32, device=idx.device)
                if n_scratch else None)
    with torch.cuda.device(idx.device):
        code = lib.s3d_segment_plan(
            idx.data_ptr(), perm.data_ptr(), offsets.data_ptr(), scratch.data_ptr(),
            None if counters is None else counters.data_ptr(), B, R, V,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "segment_plan")
    plan_launches += 1
    return perm, offsets


def scatter_add_rows_plain(src: torch.Tensor, idx: torch.Tensor, num_rows: int,
                           plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_add_rows`: the same plan,
    then one ``index_add_`` over the rows in plan order, which on the CPU adds
    one row after the other (deterministic, and the order the kernel uses)."""
    B, R, C = src.shape
    perm, _ = plan if plan is not None else sort_segments(idx, num_rows)
    perm = perm.to(torch.int64)
    sorted_idx = torch.gather(idx, 1, perm).to(torch.int64)
    dest = torch.where((sorted_idx >= 0) & (sorted_idx < num_rows), sorted_idx,
                       num_rows)                       # spare row takes the drops
    dest = dest + torch.arange(B, device=src.device)[:, None] * (num_rows + 1)
    rows = torch.gather(src.float(), 1, perm[..., None].expand(B, R, C))
    out = torch.zeros(B * (num_rows + 1), C, dtype=torch.float32, device=src.device)
    out.index_add_(0, dest.reshape(-1), rows.reshape(B * R, C))
    return out.view(B, num_rows + 1, C)[:, :num_rows].contiguous()


def scatter_add_rows(src: torch.Tensor, idx: torch.Tensor, num_rows: int,
                     plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """``out[b, v, :] = sum over r with idx[b, r] == v of src[b, r, :]``,
    summed in float32 in ascending ``r``: deterministic.

    Args:
      src: [B, R, C] float32 or bfloat16.
      idx: int32 [B, R]; entries outside ``[0, num_rows)`` are dropped.
      num_rows: V, the number of destination rows.
      plan: ``segment_plan(idx, num_rows)`` if the caller already has it.
    Returns float32 [B, V, C]. CPU tensors run the plain version; CUDA tensors
    launch the kernel (or raise), the plan kernel first when no plan is given.
    """
    _check(src, idx, "scatter_add_rows")
    B, R, C = src.shape
    if idx.shape[1] != R:
        raise ValueError(f"scatter_add_rows: {R} rows but {idx.shape[1]} indices")
    if not src.is_cuda:
        return scatter_add_rows_plain(src, idx, num_rows, plan)
    global scatter_launches
    lib = _build.load_library()
    perm, offsets = plan if plan is not None else segment_plan(idx, num_rows)
    if perm.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("scatter_add_rows: a plan is int32 (perm, offsets)")
    src, perm, offsets = _aligned(src), perm.contiguous(), offsets.contiguous()
    out = torch.empty(B, num_rows, C, dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        code = lib.s3d_scatter_add_rows(
            src.data_ptr(), perm.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            B, R, int(num_rows), C, int(src.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "scatter_add_rows")
    scatter_launches += 1
    return out


# ---------------------------------------------------------------------------
# autograd: each is the other's backward

class GatherRows(torch.autograd.Function):
    """:func:`gather_rows` whose backward is the deterministic
    :func:`scatter_add_rows` (the reference's ``_gather_bwd``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows, ctx.dtype = table.shape[1], table.dtype
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        dtable = ScatterAddRows.apply(grad, idx, ctx.num_rows, None)
        return dtable.to(ctx.dtype), None


class ScatterAddRows(torch.autograd.Function):
    """:func:`scatter_add_rows` whose backward is :func:`gather_rows`
    (dropped entries get a zero gradient)."""

    @staticmethod
    def forward(ctx, src, idx, num_rows, plan):
        ctx.save_for_backward(idx)
        ctx.num_rows, ctx.dtype = num_rows, src.dtype
        return scatter_add_rows(src, idx, num_rows, plan)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        kept = (idx >= 0) & (idx < ctx.num_rows)
        g = GatherRows.apply(grad, torch.where(kept, idx, 0))
        return (g * kept[..., None]).to(ctx.dtype), None, None, None
