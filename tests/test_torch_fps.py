"""``fps_plain`` (the plain version of the CUDA farthest-point-sampling
kernel, and what ``furthest_point_sample`` runs on CPU tensors) against the
reference: the XLA ``furthest_point_sample`` and the Pallas ``fps_pallas`` in
interpret mode (as ``tests/test_pallas_kernels.py`` runs it). Every index must
be equal: no tolerance. The CUDA kernel is held against ``fps_plain`` on the
card by ``chip_smoke.py``."""
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
