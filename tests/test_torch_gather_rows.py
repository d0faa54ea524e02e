"""``gather_rows`` / ``scatter_add_rows`` / ``segment_plan`` plain versions and
the two autograd Functions against the reference: ``vmem_gather_rows`` run in interpret mode
(as ``tests/test_pallas_kernels.py`` runs it) and its custom VJP. The gather
is exact; sums are float32 in another order, atol 1e-6 on O(1) values. The
segment plan equals a numpy stable sort exactly, and a numpy mirror of its
kernel's algorithm (cursor placement in any order, then order by rank) gives
the same plan. The CUDA kernels are held against these plain versions on the
card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from situation3d_tpu.ops.pallas.gather import vmem_gather_rows
from situation3d_tpu_torch.ops.cuda import gather_rows as tg

from torch_port_util import t2n

torch.set_num_threads(1)
ATOL = 1e-6


def _case(seed, B=2, V=40, C=128, R=256):
    r = np.random.RandomState(seed)
    table = r.randn(B, V, C).astype(np.float32)
    idx = r.randint(0, V // 2, (B, R)).astype(np.int32)     # many repeats
    ct = (r.randn(B, R, C) / 4).astype(np.float32)
    return table, idx, ct


def test_gather_plain_equals_pallas_kernel_in_interpret_mode():
    table, idx, _ = _case(0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(vmem_gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    got = tg.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))  # CPU -> plain
    assert got.dtype == torch.float32 and tg.gather_launches == 0
    np.testing.assert_array_equal(t2n(got), want)


@pytest.mark.parametrize("dtype,C", [(torch.float32, 3), (torch.bfloat16, 32),
                                     (torch.bfloat16, 6), (torch.float32, 256)])
def test_gather_any_row_that_is_a_multiple_of_4_bytes(dtype, C):
    table, idx, _ = _case(1, C=C, R=64)
    t = torch.from_numpy(table).to(dtype)
    got = tg.gather_rows(t, torch.from_numpy(idx))
    want = np.take_along_axis(t.float().numpy(), idx[..., None].astype(np.int64), axis=1)
    assert got.dtype == dtype and got.shape == (2, 64, C)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gather_backward_and_scatter_add_match_reference_vjp():
    table, idx, ct = _case(2)

    def loss(t):
        return jnp.sum(vmem_gather_rows(t, jnp.asarray(idx)) * jnp.asarray(ct))

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = tg.GatherRows.apply(t, torch.from_numpy(idx))
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(ct))
    np.testing.assert_allclose(t2n(got), want, atol=ATOL, rtol=0)
    direct = tg.scatter_add_rows(torch.from_numpy(ct), torch.from_numpy(idx), 40)
    assert direct.dtype == torch.float32 and tg.scatter_launches == 0
    np.testing.assert_allclose(t2n(direct), want, atol=ATOL, rtol=0)
    # bf16 tables get their gradient back in bf16, summed in f32 first
    tb = torch.from_numpy(table).bfloat16().requires_grad_()
    (gb,) = torch.autograd.grad(tg.GatherRows.apply(tb, torch.from_numpy(idx)), tb,
                                torch.from_numpy(ct).bfloat16())
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), want, atol=0.05, rtol=0.02)


def test_scatter_add_drops_out_of_range_like_the_reference():
    r = np.random.RandomState(3)
    src = r.randn(2, 50, 8).astype(np.float32)
    idx = r.randint(-2, 14, (2, 50)).astype(np.int32)       # -2,-1 and 12,13 are outside
    want = jnp.zeros((2, 12, 8)).at[jnp.arange(2)[:, None], jnp.asarray(
        np.where(idx < 0, 99, idx))].add(jnp.asarray(src), mode="drop")
    got = tg.scatter_add_rows(torch.from_numpy(src), torch.from_numpy(idx), 12)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=ATOL, rtol=0)
    perm, offsets = tg.sort_segments(torch.from_numpy(idx), 12)
    assert perm.dtype == torch.int32 and offsets.dtype == torch.int32
    assert offsets.shape == (2, 13)
    seg = (offsets[:, 1:] - offsets[:, :-1]).numpy()
    np.testing.assert_array_equal(seg, np.stack([np.bincount(
        i[(i >= 0) & (i < 12)], minlength=12) for i in idx]))
    again = tg.scatter_add_rows(torch.from_numpy(src), torch.from_numpy(idx), 12,
                                (perm, offsets))
    assert torch.equal(got, again)


def test_scatter_add_sums_in_index_order_and_repeats_bit_equal():
    """The sum of a destination row is the f32 sum of its rows in ascending
    ``r``: the order the kernel walks, whatever order a parallel scatter would
    pick; two runs are bit-equal."""
    r = np.random.RandomState(4)
    src = (r.randn(1, 300, 4) * 10 ** r.uniform(-3, 3, (1, 300, 1))).astype(np.float32)
    idx = r.randint(0, 5, (1, 300)).astype(np.int32)
    got = tg.scatter_add_rows(torch.from_numpy(src), torch.from_numpy(idx), 5)
    want = np.zeros((5, 4), np.float32)
    for row, i in zip(src[0], idx[0]):
        want[i] = want[i] + row
    np.testing.assert_array_equal(t2n(got[0]), want)
    assert torch.equal(got, tg.scatter_add_rows(torch.from_numpy(src),
                                                torch.from_numpy(idx), 5))


def test_scatter_add_backward_is_the_gather():
    table, idx, ct = _case(5, C=8, R=64)
    src = torch.from_numpy(ct).requires_grad_()
    bad = idx.copy()
    bad[:, :7] = -1                                          # dropped: zero gradient
    out = tg.ScatterAddRows.apply(src, torch.from_numpy(bad), 40, None)
    (got,) = torch.autograd.grad(out, src, torch.from_numpy(table))
    want = np.take_along_axis(table, np.maximum(bad, 0)[..., None].astype(np.int64), 1)
    want[:, :7] = 0
    np.testing.assert_array_equal(t2n(got), want)
    # and the gather's backward of that backward is the scatter-add again
    t = torch.from_numpy(table).requires_grad_()
    g = tg.GatherRows.apply(t, torch.from_numpy(idx))
    c = torch.from_numpy(ct).requires_grad_()
    (gt,) = torch.autograd.grad(g, t, c, create_graph=True)
    (gc,) = torch.autograd.grad(gt, c, torch.from_numpy(table))
    np.testing.assert_array_equal(
        t2n(gc), np.take_along_axis(table, idx[..., None].astype(np.int64), 1))


def test_wrappers_check_their_arguments():
    table, idx, _ = (torch.from_numpy(a) for a in _case(6, C=8, R=16))
    with pytest.raises(TypeError):
        tg.gather_rows(table, idx.long())
    with pytest.raises(TypeError):
        tg.gather_rows(table.double(), idx)
    with pytest.raises(ValueError):
        tg.gather_rows(table[0], idx)
    with pytest.raises(ValueError):
        tg.gather_rows(table.bfloat16()[..., :3], idx)      # 6-byte rows
    with pytest.raises(IndexError):
        tg.gather_rows(table, idx + 40)
    with pytest.raises(ValueError):
        tg.scatter_add_rows(table, idx, 4)                  # 40 rows, 16 indices


def _plan_reference(idx, V):
    """The plan by numpy alone: stable argsort of the key (the index where it
    lies in ``[0, V)``, ``V`` elsewhere) and the first position of each key."""
    key = np.where((idx >= 0) & (idx < V), idx, V)
    perm = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    skey = np.take_along_axis(key, perm.astype(np.int64), 1)
    offsets = np.stack([np.searchsorted(k, np.arange(V + 1), side="left") for k in skey])
    return perm, offsets.astype(np.int32)


def _plan_cases():
    r = np.random.RandomState(8)
    return {
        "repeats": (r.randint(-3, 20, (3, 500)).astype(np.int32), 17),
        "all_dropped": (r.randint(-5, 0, (2, 300)).astype(np.int32), 9),
        "one_segment": (np.full((2, 400), 4, np.int32), 6),
        "v_equals_1": (r.randint(-1, 2, (2, 64)).astype(np.int32), 1),
        "r_equals_1": (np.array([[3], [-1], [0]], np.int32), 5),
    }


@pytest.mark.parametrize("name", sorted(_plan_cases()))
def test_segment_plan_equals_sort_segments_and_a_numpy_sort(name):
    idx, V = _plan_cases()[name]
    perm, offsets = tg.segment_plan(torch.from_numpy(idx), V)      # CPU -> plain
    assert tg.plan_launches == 0
    assert perm.dtype == torch.int32 and offsets.dtype == torch.int32
    want_perm, want_off = _plan_reference(idx, V)
    np.testing.assert_array_equal(t2n(perm), want_perm)
    np.testing.assert_array_equal(t2n(offsets), want_off)
    p2, o2 = tg.sort_segments(torch.from_numpy(idx), V)
    assert torch.equal(perm, p2) and torch.equal(offsets, o2)


def _plan_by_rank(idx, V, blocks=8, warps=32, seed=0):
    """What ``csrc/segment_plan.cu`` does, step by step in numpy: counters
    split among ``blocks`` blocks, entries among ``blocks * warps`` warp
    ranges; kept entries placed through cursors in an ARBITRARY order,
    dropped ones compacted in warp-range order; then each segment put in
    order by rank (its entries smaller than each entry)."""
    rng = np.random.RandomState(seed)
    B, R = idx.shape
    vpb = max(1, -(-V // blocks))
    per_warp = -(-(-(-R // (blocks * warps))) // 32) * 32
    perms, offs = [], []
    for row in idx:
        kept = (row >= 0) & (row < V)
        counts = np.bincount(row[kept], minlength=V)
        start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        for c in range(blocks):                     # a block's range starts where
            lo = min(V, c * vpb)                    # the earlier blocks' kept end
            assert start[lo] == counts[:lo].sum()
        cursor = start[:-1].copy()
        tmp = np.full(R, -1, np.int64)
        perm = np.full(R, -1, np.int64)
        tail = int(kept.sum())
        for w0 in range(0, R, per_warp):            # warp ranges, in order
            for r in range(w0, min(R, w0 + per_warp)):
                if not kept[r]:
                    perm[tail] = r
                    tail += 1
        for r in rng.permutation(np.nonzero(kept)[0]):  # any placement order
            tmp[cursor[row[r]]] = r
            cursor[row[r]] += 1
        for v in range(V):
            seg = tmp[start[v]:start[v + 1]]
            for x in seg:
                perm[start[v] + int((seg < x).sum())] = x
        perms.append(perm)
        offs.append(start)
    return np.stack(perms).astype(np.int32), np.stack(offs).astype(np.int32)


@pytest.mark.parametrize("name", sorted(_plan_cases()))
def test_plan_by_cursor_and_rank_equals_sort_segments(name):
    """The kernel's algorithm (arbitrary placement, then rank) gives the stable
    order: shown in numpy on every plan case and two placement orders."""
    idx, V = _plan_cases()[name]
    want = tg.sort_segments(torch.from_numpy(idx), V)
    for seed in (0, 1):
        perm, offsets = _plan_by_rank(idx, V, seed=seed)
        np.testing.assert_array_equal(perm, t2n(want[0]))
        np.testing.assert_array_equal(offsets, t2n(want[1]))


@pytest.mark.parametrize("dropped", [False, True])
def test_scatter_add_plain_adds_in_ascending_r_bit_equal(dropped):
    """``scatter_add_rows_plain`` (what the kernel is held to) adds each
    destination's rows in ascending ``r``, dropped entries or not, in f32 and
    from bf16 sources."""
    r = np.random.RandomState(9)
    src = (r.randn(2, 400, 3) * 10 ** r.uniform(-3, 3, (2, 400, 1))).astype(np.float32)
    idx = r.randint(-4 if dropped else 0, 7, (2, 400)).astype(np.int32)
    for t in (torch.from_numpy(src), torch.from_numpy(src).bfloat16()):
        got = tg.scatter_add_rows_plain(t, torch.from_numpy(idx), 7)
        rows = t.float().numpy()
        want = np.zeros((2, 7, 3), np.float32)
        for b in range(2):
            for j in range(400):
                if 0 <= idx[b, j] < 7:
                    want[b, idx[b, j]] = want[b, idx[b, j]] + rows[b, j]
        np.testing.assert_array_equal(t2n(got), want)
