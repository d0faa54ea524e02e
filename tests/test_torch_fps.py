"""``fps_plain`` (the plain version of the CUDA farthest-point-sampling
kernel, and what ``furthest_point_sample`` runs on CPU tensors) against the
reference: the XLA ``furthest_point_sample`` and the Pallas ``fps_pallas`` in
interpret mode (as ``tests/test_pallas_kernels.py`` runs it). Every index must
be equal: no tolerance. A numpy mirror of the kernel's reduction (per-thread,
per-warp, per-block and cross-block winners under the layout ``fps_layout``
picks, combined by the kernel's tie rule) equals ``fps_plain`` too. The CUDA
kernel is held against ``fps_plain`` on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ops.pallas.fps import fps_pallas
from situation3d_tpu.ops.pointnet2 import furthest_point_sample as jax_fps
from situation3d_tpu_torch.ops.cuda import fps as tfps
from situation3d_tpu_torch.ops.pointnet2 import furthest_point_sample

from torch_port_util import t2n

torch.set_num_threads(1)


def _cloud(name):
    """(xyz [B, N, 3] float32, npoint) for a named case."""
    r = np.random.RandomState(sum(map(ord, name)))
    if name == "random_64":
        return r.randn(2, 64, 3).astype(np.float32), 16
    if name == "random_300":                  # N not a multiple of 32 or 128
        return (r.rand(3, 300, 3) * 4).astype(np.float32), 40
    if name == "origin_rows":                 # padding at the origin is never chosen
        xyz = r.randn(2, 96, 3).astype(np.float32)
        xyz[0, 10:30] = 0.0
        xyz[1, 0] = 0.0                        # index 0 is taken even if unselectable
        return xyz, 24
    if name == "lattice_ties":                # exact ties: lowest index must win
        g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        xyz = np.stack([g + 1.0, g[::-1] + 1.0, np.roll(g, 7, 0) + 2.0]).astype(np.float32)
        return xyz, 30
    if name == "nothing_selectable":          # row 1 is all padding: index 0 repeats
        xyz = r.randn(2, 40, 3).astype(np.float32)
        xyz[1] = 0.0
        return xyz, 8
    if name == "npoint_1":
        return r.randn(2, 33, 3).astype(np.float32), 1
    if name == "npoint_above_selectable":     # 5 selectable points, 12 asked for
        xyz = np.zeros((2, 50, 3), np.float32)
        xyz[:, [3, 11, 12, 40, 49]] = r.randn(2, 5, 3).astype(np.float32) + 3.0
        return xyz, 12
    raise KeyError(name)


CASES = ["random_64", "random_300", "origin_rows", "lattice_ties",
         "nothing_selectable", "npoint_1", "npoint_above_selectable"]


@pytest.mark.parametrize("name", CASES)
def test_fps_plain_equals_xla_and_pallas(name):
    xyz, npoint = _cloud(name)
    got = furthest_point_sample(torch.from_numpy(xyz), npoint)      # CPU -> plain version
    assert got.dtype == torch.int32 and got.shape == (len(xyz), npoint)
    assert tfps.launches == 0
    want_xla = np.asarray(jax_fps(jnp.asarray(xyz), npoint))
    want_pallas = np.asarray(fps_pallas(jnp.asarray(xyz), npoint, interpret=True))
    np.testing.assert_array_equal(t2n(got), want_xla)
    np.testing.assert_array_equal(t2n(got), want_pallas)
    assert (t2n(got)[:, 0] == 0).all()


def test_fps_case_properties():
    """What the named cases are there to show, on the port's output alone."""
    xyz, m = _cloud("origin_rows")
    got = t2n(tfps.fps_plain(torch.from_numpy(xyz), m))
    assert not np.isin(np.arange(10, 30), got[0]).any()
    assert got[1, 0] == 0 and (got[1, 1:] != 0).all()
    xyz, m = _cloud("nothing_selectable")
    assert (t2n(tfps.fps_plain(torch.from_numpy(xyz), m))[1] == 0).all()
    xyz, m = _cloud("npoint_above_selectable")
    got = t2n(tfps.fps_plain(torch.from_numpy(xyz), m))
    assert set(got[0, 1:6]) == {3, 11, 12, 40, 49}
    assert (got[:, 6:] == 3).all()            # the lowest selectable index repeats
    xyz, m = _cloud("lattice_ties")
    got = t2n(tfps.fps_plain(torch.from_numpy(xyz), m))
    assert all(len(set(row)) == m for row in got)


@pytest.mark.parametrize("name", ["random_64", "origin_rows", "lattice_ties"])
def test_fps_valid_mask_equals_xla(name):
    """The optional mask is the XLA function's (the Pallas kernel takes none)."""
    xyz, npoint = _cloud(name)
    r = np.random.RandomState(7)
    valid = r.rand(*xyz.shape[:2]) > 0.4
    valid[0, 0] = False                        # index 0 still opens the sample
    got = furthest_point_sample(torch.from_numpy(xyz), npoint, torch.from_numpy(valid))
    want = np.asarray(jax_fps(jnp.asarray(xyz), npoint, jnp.asarray(valid)))
    np.testing.assert_array_equal(t2n(got), want)
    picked = np.take_along_axis(valid, t2n(got)[:, 1:].astype(np.int64), 1)
    assert picked.all()


def test_fps_wrapper_checks_its_arguments():
    xyz = torch.from_numpy(_cloud("random_64")[0])
    with pytest.raises(TypeError):
        tfps.fps(xyz.double(), 4)
    with pytest.raises(ValueError):
        tfps.fps(xyz[0], 4)
    with pytest.raises(ValueError):
        tfps.fps(xyz[..., :2], 4)
    with pytest.raises(ValueError):
        tfps.fps(xyz, 0)
    with pytest.raises(ValueError):
        tfps.fps(xyz[:, :0], 4)
    with pytest.raises(ValueError):
        tfps.fps(xyz, 4, torch.ones(2, 64))                # not bool
    assert tfps.fps(xyz[:0], 4).shape == (0, 4)
    # a non-contiguous view and npoint above N both work
    got = tfps.fps(xyz.transpose(0, 1).contiguous().transpose(0, 1), 70)
    want = np.asarray(jax_fps(jnp.asarray(xyz.numpy()), 70))
    np.testing.assert_array_equal(t2n(got), want)


@pytest.mark.parametrize("n", [1, 31, 512, 1000, 2048, 8192, 9001, 40000, 100000])
def test_fps_layout_gives_every_point_one_owner(n):
    layout = tfps.fps_layout(n)
    bpr, threads, ppt = layout
    assert threads % 32 == 0 and 32 <= threads <= tfps.MAX_THREADS
    assert bpr in (1, tfps.CLUSTER_BLOCKS) and (bpr == 1) == (n <= tfps.BLOCK_POINTS)
    assert (threads == 32) == (n <= tfps.WARP_POINTS)
    assert ppt in (tfps.WARP_PPTS if threads == 32 else (tfps.MAX_PPT,))
    owners = tfps.fps_point_index(n, layout)
    slots = ppt if n <= tfps.MAX_POINTS else ppt + -(-(n - tfps.MAX_POINTS) // (bpr * threads))
    assert owners.shape == (bpr, slots, threads)
    assert (np.diff(owners, axis=1) > 0).all()                # a thread scans in ascending order
    real = np.sort(owners[owners < n])
    np.testing.assert_array_equal(real, np.arange(n))        # each point exactly once


def _lexmax(v, i, axis):
    """Largest v along ``axis`` and, among those, the lowest i: the tie rule
    of every level of the kernel."""
    top = v.max(axis=axis, keepdims=True)
    wi = np.where(v == top, i, np.iinfo(np.int64).max).min(axis=axis, keepdims=True)
    return np.squeeze(top, axis), np.squeeze(wi, axis)


def _fps_by_parts(xyz, npoint, valid=None):
    """A numpy mirror of ``csrc/fps.cu``'s reduction for the layout
    ``fps_layout`` picks: each thread's first best of its register slots in
    ascending order, then (v, i) winners per warp, per block and across the
    cluster, each combined by the tie rule, the winner's coordinates carried
    along. float32 throughout, the distance rounded as the kernel rounds it."""
    B, N, _ = xyz.shape
    layout = tfps.fps_layout(N)
    bpr, T, ppt = layout
    owner = tfps.fps_point_index(N, layout)                  # [bpr, ppt, T]
    real = owner < N
    at = np.where(real, owner, 0)
    out = np.zeros((B, npoint), np.int64)
    for b in range(B):
        p = xyz[b]
        x, y, z = (np.where(real, p[at, k], np.float32(0)) for k in range(3))
        mag = (x * x + y * y) + z * z
        sel = mag > np.float32(1e-3)
        if valid is not None:
            sel &= valid[b][at]
        run = np.where(real, np.where(sel, np.float32(1e10), np.float32(-1)),
                       np.float32(-3))
        xo, yo, zo = p[0]
        for j in range(1, npoint):
            dx, dy, dz = x - xo, y - yo, z - zo
            run = np.minimum(run, (dx * dx + dy * dy) + dz * dz)
            k = run.argmax(axis=1)                           # [bpr, T]: first best
            tv = np.take_along_axis(run, k[:, None], 1)[:, 0]
            ti = np.take_along_axis(owner, k[:, None], 1)[:, 0]
            wv, wi = _lexmax(tv.reshape(bpr, T // 32, 32), ti.reshape(bpr, T // 32, 32), 2)
            bv, bi = _lexmax(wv, wi, 1)                      # per block
            _, win = _lexmax(bv, bi, 0)                      # across the cluster
            out[b, j] = win
            xo, yo, zo = p[win]
    return out


def _mirror_cases():
    r = np.random.RandomState(11)
    g = np.stack(np.meshgrid(*[np.arange(16.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lattice = np.stack([g + 1.0, g[::-1] + 1.0]).astype(np.float32)      # 4,096: a block
    masked = (r.rand(2, 1000, 3) * 3 + 0.5).astype(np.float32)
    masked[0, 100:300] = 0.0
    g42 = np.stack(np.meshgrid(*[np.arange(42.0)] * 3, indexing="ij"), -1).reshape(1, -1, 3)
    return {
        "lattice_16": (lattice, 40, None),
        "masked_rows": (masked, 30, r.rand(2, 1000) > 0.3),
        "random_warp": (r.randn(3, 300, 3).astype(np.float32), 50, None),
        "random_cluster": ((r.rand(2, 9001, 3) * 4).astype(np.float32), 16, None),
        # 74,088 points: past the registers' 65,536, the rest in the scratch
        "lattice_42_above_registers": ((g42 + 1.0).astype(np.float32), 12,
                                       r.rand(1, 42 ** 3) > 0.2),
    }


@pytest.mark.parametrize("name", sorted(_mirror_cases()))
def test_fps_cluster_reduction_mirror_equals_fps_plain(name):
    xyz, npoint, valid = _mirror_cases()[name]
    got = _fps_by_parts(xyz, npoint, valid)
    want = tfps.fps_plain(torch.from_numpy(xyz), npoint,
                          None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got, t2n(want))
    if name == "lattice_16":                  # exact ties did happen and went to the lowest index
        assert len(np.unique(got[0])) == npoint
    if name == "lattice_42_above_registers":  # winners came from the scratch slots too
        assert (got >= tfps.MAX_POINTS).any()


def test_fps_layout_refuses_rows_it_cannot_hold():
    """An empty row is refused; a row longer than the registers hold takes the
    largest cluster, the rest of its points in the scratch."""
    for n in (0, -3):
        with pytest.raises(ValueError):
            tfps.fps_layout(n)
    assert tfps.fps_layout(tfps.MAX_POINTS + 1) == (
        tfps.CLUSTER_BLOCKS, tfps.MAX_THREADS, tfps.MAX_PPT)
    assert tfps.fps_layout(tfps.MAX_POINTS) == (
        tfps.CLUSTER_BLOCKS, tfps.MAX_THREADS, tfps.MAX_PPT)
