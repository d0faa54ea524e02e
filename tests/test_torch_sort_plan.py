"""The sort-based plan of the port (``sparse/kernel_map.py``:
``build_kernel_map``, ``downsample_coords``, ``gather_neighbors``; and
``build_unet_plan`` with ``dense_lookup=false`` or ``dense_downsample=false``)
against the reference, bit for bit, overflow counters included; on in-extent
scenes equal to the port's dense plan (the reference's pin
``test_dense_lookup_matches_sort_path``); a tiny MinkUNet forward on it
within 1e-5 of the reference's on its own sort plan."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.sparse import kernel_map as jkm
from situation3d_tpu.sparse.minkunet import MinkUNet as JMinkUNet
from situation3d_tpu.sparse.minkunet import build_unet_plan as jax_build_unet_plan
from situation3d_tpu.sparse.tensor import SparseVoxels as JSparseVoxels
from situation3d_tpu_torch.ops.cuda import fused_conv, map_bits, map_lookup
from situation3d_tpu_torch.sparse import kernel_map as tkm
from situation3d_tpu_torch.sparse.minkunet import MinkUNet, build_unet_plan
from situation3d_tpu_torch.sparse.tensor import SparseVoxels

from torch_port_util import load_into_port, random_variables_of, t2n, tiny_cfgs

torch.set_num_threads(1)
ATOL = 1e-5


def _scene(seed, B, cap, n, span, extra=None, dup=0):
    """Unique voxels per sample, ``extra`` rows appended to sample 0 and
    ``dup`` of its rows repeated (duplicate coords collide in both
    packages)."""
    r = np.random.RandomState(seed)
    coords = np.zeros((B, cap, 3), np.int32)
    mask = np.zeros((B, cap), bool)
    for b in range(B):
        c = np.unique(np.stack([r.randint(0, s, n + 30) for s in span], 1), axis=0)[:n]
        r.shuffle(c)
        if b == 0:
            if extra is not None:
                c = np.concatenate([c, np.asarray(extra, np.int32)])
            c = np.concatenate([c, c[:dup]])
        coords[b, :len(c)], mask[b, :len(c)] = c, True
    return coords, mask


def _eq(got, want, msg=""):
    got, want = t2n(got), np.asarray(want)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("k,in_stride,offset_stride", [
    (3, 1, 1), (5, 1, 1), (3, 4, 4), (2, 2, 2), (-2, 4, 2)],
    ids=["k3", "k5", "k3_s4", "k2_down", "k2_up"])
def test_build_kernel_map(k, in_stride, offset_stride):
    """Misses, masked rows, queries below zero or past ``COORD_BOUND``,
    queries not divisible by the input stride, and duplicate coords (the
    lowest row wins)."""
    offsets = -jkm.kernel_offsets(-k) if k < 0 else jkm.kernel_offsets(k)
    ci, mi = _scene(1, 3, 96, 80, (12, 10, 8), extra=[[0, 0, 0], [1023, 1023, 1023]],
                    dup=5)
    co, mo = _scene(2, 3, 64, 50, (12, 10, 8), extra=[[1023, 0, 1023]])
    ci, co = ci * in_stride, co * offset_stride
    mi[2, :] = False                                      # an empty input sample
    mo[1, 10:20] = False
    got = tkm.build_kernel_map(torch.from_numpy(ci), torch.from_numpy(mi),
                               torch.from_numpy(co), torch.from_numpy(mo), offsets,
                               in_stride, offset_stride)
    want = jax.vmap(lambda a, b, c, d: jkm.build_kernel_map(
        a, b, c, d, jnp.asarray(offsets), in_stride, offset_stride))(
        *map(jnp.asarray, (ci, mi, co, mo)))
    _eq(got, want)
    assert 0 < int((t2n(got) < 96).sum()) < got.numel()


@pytest.mark.parametrize("capacity", [128, 24])
def test_downsample_coords(capacity):
    """The sorted dedup, overflow merged into the last slot (the largest key)
    and counted."""
    coords, mask = _scene(3, 3, 128, 100, (40, 30, 20), extra=[[900, 3, 1]], dup=4)
    coords *= 2
    mask[2] = False
    got = tkm.downsample_coords(torch.from_numpy(coords), torch.from_numpy(mask), 2, 2,
                                capacity)
    want = jax.vmap(lambda c, m: jkm.downsample_coords(c, m, 2, 2, capacity))(
        jnp.asarray(coords), jnp.asarray(mask))
    for g, w, name in zip(got, want, ("coords", "mask", "dropped")):
        _eq(g, w, name)
    assert (int(got[2][0]) > 0) == (capacity == 24)


def test_gather_neighbors():
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 7, 5).astype(np.float32)
    idx = rng.randint(0, 8, (2, 6, 4)).astype(np.int32)        # 7 == miss
    got = tkm.gather_neighbors(torch.from_numpy(feats), torch.from_numpy(idx))
    np.testing.assert_array_equal(t2n(got), np.asarray(jkm.gather_neighbors(
        jnp.asarray(feats), jnp.asarray(idx))))


def _plan_case():
    """Level 1+ overflow, voxels past the extent (below ``COORD_BOUND``),
    an all-invalid sample."""
    caps = (256, 128, 64, 32, 16)
    coords, mask = _scene(4, 3, caps[0], 200, (100, 110, 60),
                          extra=[[130, 5, 5], [5, 5, 70], [700, 900, 300]])
    mask[2] = False
    return caps, coords, mask


PLANS = [dict(dense_lookup=False, dense_downsample=True),
         dict(dense_lookup=False, dense_downsample=False),
         dict(dense_lookup=True, dense_downsample=False, pallas_map=True,
              pallas_map_bits=True),
         dict(dense_lookup=True, dense_downsample=False, pallas_map=False,
              pallas_map_bits=False)]


@functools.lru_cache(maxsize=None)
def _jax_plan(dense_lookup, dense_downsample):
    """The reference's plan of ``_plan_case`` (one compile a distinct plan:
    without ``dense_lookup`` it ignores ``dense_downsample``, and on the CPU
    its map-kernel switches)."""
    caps, coords, mask = _plan_case()
    return jax.jit(lambda c, m: jax_build_unet_plan(
        c, m, caps, dense_lookup=dense_lookup, extent=(128, 128, 64), need_k5=True,
        dense_downsample=dense_downsample))(jnp.asarray(coords), jnp.asarray(mask))


@pytest.mark.parametrize("flags", PLANS, ids=["sort", "sort_nodd", "grid_sortdown",
                                               "dense_sortdown"])
def test_build_unet_plan_bit_for_bit(flags):
    caps, coords, mask = _plan_case()
    extent = (128, 128, 64)
    map_lookup.launches = map_lookup.k5_launches = map_bits.launches = 0
    got = build_unet_plan(coords, mask, caps, extent, device="cpu", **flags)
    want = _jax_plan(flags["dense_lookup"], flags["dense_lookup"] and flags["dense_downsample"])
    for i, (gl, wl) in enumerate(zip(got["levels"], want["levels"])):
        assert set(gl) == set(wl), (i, set(gl), set(wl))
        for key in wl:
            _eq(gl[key], wl[key], f"level{i}/{key}")
    for key in want["overflow"]:
        _eq(got["overflow"][key], want["overflow"][key], key)
    assert int(got["overflow"]["voxels_dropped"].sum()) > 0
    misses = int(got["overflow"]["extent_misses"][0])
    assert (misses > 0) == flags["dense_lookup"], misses
    assert map_lookup.launches == map_lookup.k5_launches == map_bits.launches == 0


def test_sort_plan_routes_no_map_kernel_and_level1_like_the_reference(monkeypatch):
    """``dense_lookup=false`` calls no map kernel; ``dense_downsample=false``
    sends level 1 to the grid kernel where it fits, never to the bit tables
    (the reference requires the dense downsample for them)."""
    from situation3d_tpu_torch.sparse import minkunet as mu
    calls = []
    for name in ("k3_map_lookup", "k3_map_lookup_bits", "k5_map_lookup"):
        real = getattr(mu, name)
        monkeypatch.setattr(mu, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    caps, coords, mask = _plan_case()
    mu.build_unet_plan(coords, mask, caps, (128, 128, 64), device="cpu", dense_lookup=False)
    assert calls == []
    mu.build_unet_plan(coords, mask, caps, (128, 128, 64), device="cpu",
                       dense_downsample=False)
    assert calls == ["k5_map_lookup"] + ["k3_map_lookup"] * 4


def test_sort_plan_equals_dense_plan_in_extent():
    """In extent the three plans hold the same tensors (the reference pins
    its dense plan to its sort plan the same way)."""
    caps = (256, 256, 128, 64, 32)
    coords, mask = _scene(5, 2, caps[0], 200, (28, 28, 28))
    dense = build_unet_plan(coords, mask, caps, (64, 64, 64), device="cpu")
    for flags in (dict(dense_lookup=False), dict(dense_downsample=False)):
        other = build_unet_plan(coords, mask, caps, (64, 64, 64), device="cpu", **flags)
        for i in range(5):
            assert set(other["levels"][i]) == set(dense["levels"][i])
            for key, val in dense["levels"][i].items():
                assert torch.equal(other["levels"][i][key], val), (flags, i, key)
        for key, val in dense["overflow"].items():
            assert torch.equal(other["overflow"][key], val), key


def test_minkunet_forward_on_the_sort_plan():
    """A scene past the extent: the tiny f32 MinkUNet on the sort plan
    within 1e-5 of the reference's, at the bottleneck and the two decoder
    layers (the transposed convs run on the sorted ``map_up``)."""
    jcfg, tcfg = tiny_cfgs(("sparse.dense_lookup=false",))
    js, ts = jcfg.sparse, tcfg.sparse
    caps, coords, mask = _plan_case()
    js = js.__class__(**{**js.__dict__, "capacities": caps})
    ts = ts.__class__(**{**ts.__dict__, "capacities": caps})
    rng = np.random.RandomState(6)
    feats = (rng.rand(*coords.shape) * mask[..., None]).astype(np.float32)
    names = ("feat_bottleneck", "feat_layer5", "feat_layer6")
    # the plans are bit-equal (test_build_unet_plan_bit_for_bit): the
    # reference runs on the port's, which spares it a compile
    plan = build_unet_plan(coords, mask, caps, ts.grid_extent, device="cpu",
                           dense_lookup=False)
    jplan = jax.tree_util.tree_map(lambda t: jnp.asarray(t2n(t)), plan)
    x = JSparseVoxels(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                      mask=jnp.asarray(mask), stride=1)
    jnet = JMinkUNet(js)
    v = random_variables_of(
        lambda: jnet.init(jax.random.PRNGKey(0), x, jplan, train=False), rng)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, x, p: {k: o.feats for k, o in
                                        jnet.apply(v, x, p, train=False).items()})(v, x, jplan)
    net = load_into_port(MinkUNet(ts), v).eval()
    xt = SparseVoxels(*map(torch.from_numpy, (coords, feats, mask)), 1)
    fused_conv.launches = 0
    with torch.no_grad():
        got = net(xt, plan)
    for k in names:
        w = np.asarray(want[k])
        assert np.abs(w).max() > 1e-2, k
        np.testing.assert_allclose(t2n(got[k].feats), w, atol=ATOL, rtol=0, err_msg=k)
    assert fused_conv.launches == 0
