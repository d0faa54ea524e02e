"""The port's ``ops/pointnet2.py`` and ``ops/nn_distance.py`` against the
reference's, on the same numpy-seeded inputs. Index outputs must be equal;
float tolerances are stated at each comparison."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ops import nn_distance as jnn
from situation3d_tpu.ops import pointnet2 as jp
from situation3d_tpu_torch.ops import nn_distance as tnn
from situation3d_tpu_torch.ops import pointnet2 as tp
from situation3d_tpu_torch.ops.cuda import gather_rows

from torch_port_util import t2n

torch.set_num_threads(1)
BOUNDARY_REL = 1e-6    # rows with a point this close (relative) to r^2 are not compared


def _near_boundary(xyz, centers, radius):
    """[B, M] bool: some point lies within BOUNDARY_REL (relative) of the
    radius, in float64: there the two float32 roundings may fall either way."""
    d2 = ((centers[:, :, None, :].astype(np.float64)
           - xyz[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    r2 = float(radius) ** 2
    return (np.abs(d2 - r2) <= BOUNDARY_REL * r2).any(-1)


@pytest.mark.parametrize("radius,nsample,with_valid", [
    (0.2, 8, False), (0.4, 16, False), (0.3, 64, True), (0.05, 4, False)])
def test_ball_query_indices_equal(radius, nsample, with_valid):
    r = np.random.RandomState(int(radius * 100) + nsample)
    xyz = r.rand(2, 200, 3).astype(np.float32)
    centers = np.concatenate([xyz[:, :24], r.rand(2, 8, 3).astype(np.float32) + 5.0], 1)
    valid = (r.rand(2, 200) > 0.3) if with_valid else None
    want = np.asarray(jp.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(centers),
                                    None if valid is None else jnp.asarray(valid)))
    got = tp.ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(centers),
                        None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.int32 and got.shape == (2, 32, nsample)
    keep = ~_near_boundary(xyz, centers, radius)
    left_out = int((~keep).sum())
    assert left_out <= 2, f"{left_out} of {keep.size} rows lie on the radius"
    np.testing.assert_array_equal(t2n(got)[keep], want[keep])
    assert (t2n(got)[:, 24:] == 0).all()                  # no hit -> index 0
    if valid is not None:
        hit = t2n(got)[:, :24].astype(np.int64)
        d2 = ((centers[:, :24, None] - xyz[:, None]) ** 2).sum(-1)
        any_hit = ((d2 < radius ** 2) & valid[:, None]).any(-1)
        assert np.take_along_axis(valid, hit.reshape(2, -1), 1).reshape(hit.shape)[any_hit].all()


def test_ball_query_chunks_of_centres_change_nothing(monkeypatch):
    r = np.random.RandomState(3)
    xyz = torch.from_numpy(r.rand(2, 150, 3).astype(np.float32))
    whole = tp.ball_query(0.3, 8, xyz, xyz[:, :50])
    monkeypatch.setattr(tp, "PAIRWISE_CHUNK_BYTES", 4 * 2 * 150 * 7)   # 7 centres a chunk
    assert torch.equal(tp.ball_query(0.3, 8, xyz, xyz[:, :50]), whole)
    d, i = tp.three_nn(xyz[:, :50], xyz[:, 50:])
    monkeypatch.setattr(tp, "PAIRWISE_CHUNK_BYTES", 2 ** 28)
    d2, i2 = tp.three_nn(xyz[:, :50], xyz[:, 50:])
    assert torch.equal(d, d2) and torch.equal(i, i2)


@pytest.mark.parametrize("C", [3, 8])
def test_gather_and_group_points_exact(C):
    r = np.random.RandomState(C)
    pts = r.randn(2, 40, C).astype(np.float32)
    idx = r.randint(0, 40, (2, 12)).astype(np.int32)
    gidx = r.randint(0, 40, (2, 12, 5)).astype(np.int32)
    gather_rows.gather_launches = 0
    got = tp.gather_points(torch.from_numpy(pts), torch.from_numpy(idx))
    np.testing.assert_array_equal(
        t2n(got), np.asarray(jp.gather_points(jnp.asarray(pts), jnp.asarray(idx))))
    got = tp.group_points(torch.from_numpy(pts), torch.from_numpy(gidx).long())
    np.testing.assert_array_equal(
        t2n(got), np.asarray(jp.group_points(jnp.asarray(pts), jnp.asarray(gidx))))
    assert got.shape == (2, 12, 5, C) and gather_rows.gather_launches == 0


def test_three_nn_distances_and_index_sets():
    """Distances within 1e-5 (float32 expanded form, values O(1)); the order
    among equal distances is unspecified in both, so indices compare as sets."""
    r = np.random.RandomState(5)
    unknown = r.rand(2, 60, 3).astype(np.float32)
    known = r.rand(2, 25, 3).astype(np.float32)
    kv = r.rand(2, 25) > 0.2
    for valid in (None, kv):
        wd, wi = jp.three_nn(jnp.asarray(unknown), jnp.asarray(known),
                             None if valid is None else jnp.asarray(valid))
        gd, gi = tp.three_nn(torch.from_numpy(unknown), torch.from_numpy(known),
                             None if valid is None else torch.from_numpy(valid))
        assert gi.dtype == torch.int32
        np.testing.assert_allclose(t2n(gd), np.asarray(wd), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.sort(t2n(gi), -1), np.sort(np.asarray(wi), -1))
        assert (np.diff(t2n(gd), axis=-1) >= 0).all()       # nearest first
    w = tp.interpolation_weights(gd)
    np.testing.assert_allclose(t2n(w), np.asarray(jp.interpolation_weights(wd)),
                               atol=1e-5, rtol=1e-5)


def test_three_interpolate_value_and_gradients():
    """Value and both gradients against ``jax.grad`` within 1e-5 (sums of
    three float32 products; the feature gradient is a scatter-add of up to a
    few dozen terms of order 1)."""
    r = np.random.RandomState(6)
    feats = r.randn(2, 10, 16).astype(np.float32)
    idx = r.randint(0, 10, (2, 30, 3)).astype(np.int32)
    weight = r.rand(2, 30, 3).astype(np.float32)
    ct = r.randn(2, 30, 16).astype(np.float32)

    def f(fe, w):
        return jnp.sum(jp.three_interpolate(fe, jnp.asarray(idx), w) * jnp.asarray(ct))
    want = np.asarray(jp.three_interpolate(jnp.asarray(feats), jnp.asarray(idx),
                                           jnp.asarray(weight)))
    wf, ww = jax.grad(f, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(weight))
    tf, tw = (torch.from_numpy(a).requires_grad_() for a in (feats, weight))
    got = tp.three_interpolate(tf, torch.from_numpy(idx), tw)
    gf, gw = torch.autograd.grad(got, (tf, tw), torch.from_numpy(ct))
    np.testing.assert_allclose(t2n(got), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t2n(gf), np.asarray(wf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t2n(gw), np.asarray(ww), atol=1e-5, rtol=0)


def test_gather_points_gradient_is_the_deterministic_scatter_add():
    r = np.random.RandomState(8)
    pts = r.randn(2, 12, 3).astype(np.float32)
    idx = r.randint(0, 4, (2, 40)).astype(np.int32)         # many repeats
    ct = r.randn(2, 40, 3).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jp.gather_points(p, jnp.asarray(idx))
                                      * jnp.asarray(ct)))(jnp.asarray(pts))
    t = torch.from_numpy(pts).requires_grad_()
    (g1,) = torch.autograd.grad(tp.gather_points(t, torch.from_numpy(idx)), t,
                                torch.from_numpy(ct))
    (g2,) = torch.autograd.grad(tp.gather_points(t, torch.from_numpy(idx)), t,
                                torch.from_numpy(ct))
    np.testing.assert_allclose(t2n(g1), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("form", ["l2", "l1", "huber"])
def test_nn_distance_forms(form):
    """Distances within 1e-6 relative; nearest indices equal (the first among
    equal minima in both)."""
    r = np.random.RandomState(9)
    a = r.randn(3, 20, 3).astype(np.float32)
    b = r.randn(3, 7, 3).astype(np.float32)
    b[:, 3] = b[:, 1]                                       # an exact tie on side 2
    kw = {"l2": {}, "l1": {"l1": True}, "huber": {"l1smooth": True, "delta": 0.7}}[form]
    want = jnn.nn_distance(jnp.asarray(a), jnp.asarray(b), **kw)
    got = tnn.nn_distance(torch.from_numpy(a), torch.from_numpy(b), **kw)
    for g, w, is_idx in zip(got, want, (False, True, False, True)):
        if is_idx:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(t2n(g), np.asarray(w))
        else:
            np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    e = r.randn(50).astype(np.float32) * 2
    np.testing.assert_allclose(t2n(tnn.huber_loss(torch.from_numpy(e), 0.7)),
                               np.asarray(jnn.huber_loss(jnp.asarray(e), 0.7)),
                               rtol=1e-6, atol=1e-7)
