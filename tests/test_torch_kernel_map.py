"""Plan building of the port against the reference, bit for bit: voxel
dedup, level grids, dense lookups, the sort-free downsample with its k2
maps, and the whole ``build_unet_plan`` on each k3-map route its extent
picks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ops.voxelize import voxelize_jax
from situation3d_tpu.sparse import kernel_map as jkm
from situation3d_tpu.sparse.minkunet import build_unet_plan as jax_build_unet_plan
from situation3d_tpu_torch.config import Config, apply_overrides
from situation3d_tpu_torch.models import sig3d as tsig
from situation3d_tpu_torch.ops.voxelize import (pack_coords, unpack_coords,
                                                voxelize_torch)
from situation3d_tpu_torch.sparse import kernel_map as tkm
from situation3d_tpu_torch.sparse.minkunet import build_unet_plan

from torch_port_util import TINY, t2n

torch.set_num_threads(1)


def _scene(seed, B, cap, n, span, extra=None):
    """Unique voxels per sample; ``extra`` rows are appended verbatim (for
    out-of-extent or negative coords); sample B-1 can be emptied by the caller."""
    r = np.random.RandomState(seed)
    coords = np.zeros((B, cap, 3), np.int32)
    mask = np.zeros((B, cap), bool)
    for b in range(B):
        c = np.unique(np.stack([r.randint(0, s, n + 30) for s in span], 1), axis=0)[:n]
        if extra is not None and b == 0:
            c = np.concatenate([c, np.asarray(extra, np.int32)])
        coords[b, :len(c)], mask[b, :len(c)] = c, True
    return coords, mask


def _eq(got, want, msg=""):
    got = t2n(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_kernel_offsets(k):
    np.testing.assert_array_equal(tkm.kernel_offsets(k), jkm.kernel_offsets(k))


def test_pack_unpack_coords():
    c = np.random.RandomState(0).randint(0, 1024, (50, 3)).astype(np.int32)
    keys = pack_coords(torch.from_numpy(c))
    _eq(keys, jkm.pack_coords(jnp.asarray(c)))
    _eq(unpack_coords(keys), c)


@pytest.mark.parametrize("capacity", [200, 40])          # 40 forces overflow
def test_voxelize_torch(capacity):
    r = np.random.RandomState(1)
    B, N = 3, 160
    coords = r.randint(0, 6, (B, N, 3)).astype(np.int32)  # many duplicates
    valid = r.rand(B, N) < 0.8
    valid[2] = False                                      # all-invalid sample
    got = voxelize_torch(torch.from_numpy(coords), torch.from_numpy(valid), capacity)
    want = jax.vmap(lambda c, v: voxelize_jax(c, v, capacity))(
        jnp.asarray(coords), jnp.asarray(valid))
    for g, w, name in zip(got, want, ("coords", "mask", "inverse", "num_unique")):
        _eq(g, w, name)
    if capacity == 40:
        assert int(got[3].max()) > capacity


@pytest.mark.parametrize("stride,extent", [(1, (32, 32, 16)), (2, (64, 48, 32)),
                                           (4, (64, 64, 64))])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_level_grid_and_dense_lookup(stride, extent, k):
    cells = tuple(e // stride for e in extent)
    # in-extent voxels plus one beyond the extent and one negative
    coords, mask = _scene(2, 2, 128, 90, cells,
                          extra=[[cells[0] + 1, 0, 0], [-1, 2, 2]])
    coords *= stride
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    grid, misses = tkm.build_level_grid(tc, tm, stride, extent)
    jgrid, jmisses = jax.vmap(lambda c, m: jkm.build_level_grid(c, m, stride, extent))(
        jnp.asarray(coords), jnp.asarray(mask))
    _eq(grid, jgrid, "grid")
    _eq(misses, jmisses, "misses")
    assert int(misses[0]) == 2
    offs = tkm.kernel_offsets(k)
    for offset_stride in (stride, stride // 2 or stride):   # 2nd: parity misses
        got = tkm.lookup_kernel_map_dense(grid, 128, tc, tm, offs, stride,
                                          offset_stride, extent)
        want = jax.vmap(lambda g, c, m: jkm.lookup_kernel_map_dense(
            g, 128, c, m, jnp.asarray(offs), stride, offset_stride, extent))(
            jgrid, jnp.asarray(coords), jnp.asarray(mask))
        _eq(got, want, f"map k{k} os{offset_stride}")


@pytest.mark.parametrize("capacity", [256, 48])           # 48 forces overflow
@pytest.mark.parametrize("stride", [1, 2])
def test_downsample_with_down_map(capacity, stride):
    extent = (64, 64, 32)
    cells = tuple(e // stride for e in extent)
    coords, mask = _scene(3, 3, 256, 200, cells,
                          extra=[[cells[0] + 3, 1, 1], [2, -1, 0]])
    coords *= stride
    mask[2] = False                                       # all-invalid sample
    got = tkm.downsample_with_down_map(torch.from_numpy(coords),
                                       torch.from_numpy(mask), stride, 2,
                                       capacity, extent)
    want = jax.vmap(lambda c, m: jkm.downsample_with_down_map(
        c, m, stride, 2, capacity, extent))(jnp.asarray(coords), jnp.asarray(mask))
    for g, w, name in zip(got, want, ("coords", "mask", "dropped", "down", "up")):
        _eq(g, w, name)
    assert int(got[2][0]) >= 2                            # the two extras
    if capacity == 48:
        assert int(got[2][0]) > 2


def _plan_case(span):
    caps = (256, 128, 64, 32, 16)                         # level 1+ overflow
    coords, mask = _scene(4, 3, caps[0], 200, span,
                          extra=[[130, 5, 5], [5, 5, 70]])  # beyond the extent
    mask[2] = False                                       # all-invalid sample
    return caps, coords, mask


def _record_routes(monkeypatch):
    """Patch the plan's map routes to log (route, level cells) through the
    wrappers; returns the log."""
    from situation3d_tpu_torch.sparse import minkunet as mu
    calls = []
    real = {name: getattr(mu, name) for name in (
        "k5_map_lookup", "k3_map_lookup", "k3_map_lookup_bits", "lookup_kernel_map_dense")}
    monkeypatch.setattr(mu, "k5_map_lookup",
                        lambda *a: calls.append(("k5", a[3])) or real["k5_map_lookup"](*a))
    monkeypatch.setattr(mu, "k3_map_lookup",
                        lambda *a: calls.append(("grid", a[3])) or real["k3_map_lookup"](*a))
    monkeypatch.setattr(mu, "k3_map_lookup_bits",
                        lambda *a: calls.append(("bits", a[4])) or real["k3_map_lookup_bits"](*a))
    monkeypatch.setattr(mu, "lookup_kernel_map_dense", lambda *a: calls.append(
        ("plain", tuple(e // a[5] for e in a[7]))) or real["lookup_kernel_map_dense"](*a))
    return calls


def _routes(extent, level1, rest):
    """The route log of a plan over ``extent``: k5 at level 0, ``level1`` at
    level 1 and ``rest`` at levels 2-4."""
    cells = [tuple(e // s for e in extent) for s in (1, 2, 4, 8, 16)]
    return [("k5", cells[0]), (level1, cells[1])] + [(rest, c) for c in cells[2:]]


# each extent's own cells pick the route (map_lookup_fits, then map_bits_fits);
# the last entry is the reference's kernel switches. Its maps are one plan
# whichever kernel builds them; at (64, 64, 512) its interpret-mode kernels
# would take half a minute, so it builds that plan on its XLA lookup (the
# port's bit-table lookup is held to the reference's kernel in
# test_torch_map_kernels.py)
PLAN_EXTENTS = [((128, 128, 64), (100, 110, 60), "grid", "grid", dict(pallas_map="force")),
                ((64, 64, 512), (60, 60, 300), "bits", "grid", {}),   # level 1: 256 z-cells
                ((128, 128, 96), (100, 110, 60), "plain", "plain", {})]


@pytest.mark.parametrize("extent,span,level1,rest,reference", PLAN_EXTENTS,
                         ids=["grid", "bits", "dense"])
def test_build_unet_plan_bit_for_bit(extent, span, level1, rest, reference, monkeypatch):
    caps, coords, mask = _plan_case(span)
    calls = _record_routes(monkeypatch)
    got = build_unet_plan(coords, mask, caps, extent, device="cpu")
    assert calls == _routes(extent, level1, rest)
    want = jax.jit(lambda c, m: jax_build_unet_plan(
        c, m, caps, dense_lookup=True, extent=extent, need_k5=True, dense_downsample=True,
        **reference))(jnp.asarray(coords), jnp.asarray(mask))
    assert len(got["levels"]) == 5
    for i, (gl, wl) in enumerate(zip(got["levels"], want["levels"])):
        assert set(gl) == set(wl), (i, set(gl), set(wl))
        for key in wl:
            _eq(gl[key], wl[key], f"level{i}/{key}")
    for key in want["overflow"]:
        _eq(got["overflow"][key], want["overflow"][key], key)
    assert int(got["overflow"]["voxels_dropped"].sum()) > 0
    # the voxels of sample 0 outside the extent, all counted at level 0
    outside = int((mask[0] & ((coords[0] < 0) | (coords[0] >= extent)).any(1)).sum())
    assert outside >= 1 and int(got["overflow"]["extent_misses"][0]) == outside


@pytest.mark.parametrize("option", ["sparse.pallas_map=false", "sparse.pallas_map_bits=false",
                                    "sparse.dense_downsample=false"])
def test_retired_plan_fields_change_no_plan(option, monkeypatch):
    """The reference's switches for its downsample and its two map kernels
    are read and ignored: SIG3D builds the default plan with each at its
    non-default value, bit for bit and through the same routes, on a scene
    partly past the extent (where a sorted downsample gives another plan)."""
    extent = (64, 64, 512)
    cfg = apply_overrides(Config(), [*TINY, "sparse.grid_extent=(64,64,512)", option])
    caps = cfg.sparse.capacities
    coords, mask = _scene(7, 2, caps[0], 300, (80, 60, 300))   # x past 64
    want_calls = _routes(extent, "bits", "grid")
    calls = _record_routes(monkeypatch)
    want = build_unet_plan(coords, mask, caps, extent, device="cpu")
    assert calls == want_calls and int(want["overflow"]["extent_misses"][0]) > 0
    del calls[:]
    plans = []
    real = tsig.build_unet_plan
    monkeypatch.setattr(tsig, "build_unet_plan",
                        lambda *a, **kw: plans.append(real(*a, **kw)) or plans[-1])
    model = tsig.SIG3D(cfg, 5, device="cpu")
    feats = np.random.RandomState(8).rand(*coords.shape).astype(np.float32) * mask[..., None]
    with torch.no_grad():
        model.encode_scene({"voxel_coords": coords, "voxel_feats": feats, "voxel_mask": mask},
                           generator=torch.Generator().manual_seed(0))
    assert calls == want_calls and len(plans) == 1
    got = plans[0]
    for i, (gl, wl) in enumerate(zip(got["levels"], want["levels"])):
        assert set(gl) == set(wl), (i, set(gl), set(wl))
        for key, val in wl.items():
            assert torch.equal(gl[key], val), (option, i, key)
    for key, val in want["overflow"].items():
        assert torch.equal(got["overflow"][key], val), key


def test_build_unet_plan_routes_like_the_reference(monkeypatch):
    """At the default extent level 0's k5 map (with its k3 map) goes to the
    int32-grid kernel with the k5 offsets, level 1 to the bit-table kernel
    and levels 2-4 to the int32-grid kernel (counted through the
    wrappers)."""
    from situation3d_tpu_torch.sparse import minkunet as mu
    calls = _record_routes(monkeypatch)
    caps = (64, 32, 16, 8, 4)
    coords, mask = _scene(5, 1, caps[0], 50, (300, 300, 150))
    # level 0 of the default extent is a 268 MB grid per sample: B = 1 only
    plan = mu.build_unet_plan(coords, mask, caps, (512, 512, 256), device="cpu")
    assert calls == _routes((512, 512, 256), "bits", "grid")
    level0 = plan["levels"][0]
    assert level0["map_k5"].shape == (1, caps[0], 125)
    assert torch.equal(level0["map_k3"], level0["map_k5"][:, :, [
        int(np.flatnonzero((tkm.kernel_offsets(5) == o).all(1))[0])
        for o in tkm.kernel_offsets(3)]])
