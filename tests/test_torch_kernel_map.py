"""Plan building of the port against the reference, bit for bit: voxel
dedup, level grids, dense lookups, the sort-free downsample with its k2
maps, and the whole ``build_unet_plan`` in both k3-map routings."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ops.voxelize import voxelize_jax
from situation3d_tpu.sparse import kernel_map as jkm
from situation3d_tpu.sparse.minkunet import build_unet_plan as jax_build_unet_plan
from situation3d_tpu_torch.ops.voxelize import (pack_coords, unpack_coords,
                                                voxelize_torch)
from situation3d_tpu_torch.sparse import kernel_map as tkm
from situation3d_tpu_torch.sparse.minkunet import build_unet_plan

from torch_port_util import t2n

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


def _plan_case():
    caps = (256, 128, 64, 32, 16)                         # level 1+ overflow
    coords, mask = _scene(4, 3, caps[0], 200, (100, 110, 60),
                          extra=[[130, 5, 5], [5, 5, 70]])  # beyond the extent
    mask[2] = False                                       # all-invalid sample
    return caps, coords, mask


@pytest.mark.parametrize("routing", [
    dict(pallas_map="force", pallas_map_bits=False),      # grid kernel, levels 1-4
    dict(pallas_map=False, pallas_map_bits="force"),      # bits where Z % 32 == 0
    dict(pallas_map=False, pallas_map_bits=False),        # plain dense lookup
], ids=["grid", "bits", "dense"])
def test_build_unet_plan_bit_for_bit(routing):
    caps, coords, mask = _plan_case()
    extent = (128, 128, 64)
    got = build_unet_plan(coords, mask, caps, extent, device="cpu", **routing)
    want = jax.jit(lambda c, m: jax_build_unet_plan(
        c, m, caps, dense_lookup=True, extent=extent, need_k5=True,
        dense_downsample=True, **routing))(jnp.asarray(coords), jnp.asarray(mask))
    assert len(got["levels"]) == 5
    for i, (gl, wl) in enumerate(zip(got["levels"], want["levels"])):
        assert set(gl) == set(wl), (i, set(gl), set(wl))
        for key in wl:
            _eq(gl[key], wl[key], f"level{i}/{key}")
    for key in want["overflow"]:
        _eq(got["overflow"][key], want["overflow"][key], key)
    assert int(got["overflow"]["voxels_dropped"].sum()) > 0
    assert int(got["overflow"]["extent_misses"][0]) == 2


def test_build_unet_plan_routes_like_the_reference(monkeypatch):
    """At the default extent level 0's k5 map (with its k3 map) goes to the
    int32-grid kernel with the k5 offsets, level 1 to the bit-table kernel
    and levels 2-4 to the int32-grid kernel (counted through the
    wrappers)."""
    from situation3d_tpu_torch.sparse import minkunet as mu
    calls = []
    real_grid, real_bits, real_k5 = mu.k3_map_lookup, mu.k3_map_lookup_bits, mu.k5_map_lookup
    monkeypatch.setattr(mu, "k3_map_lookup",
                        lambda *a: calls.append(("grid", a[3])) or real_grid(*a))
    monkeypatch.setattr(mu, "k3_map_lookup_bits",
                        lambda *a: calls.append(("bits", a[4])) or real_bits(*a))
    monkeypatch.setattr(mu, "k5_map_lookup",
                        lambda *a: calls.append(("k5", a[3])) or real_k5(*a))
    caps = (64, 32, 16, 8, 4)
    coords, mask = _scene(5, 1, caps[0], 50, (300, 300, 150))
    # level 0 of the default extent is a 268 MB grid per sample: B = 1 only
    plan = mu.build_unet_plan(coords, mask, caps, (512, 512, 256), device="cpu")
    assert calls == [("k5", (512, 512, 256)), ("bits", (256, 256, 128)),
                     ("grid", (128, 128, 64)), ("grid", (64, 64, 32)), ("grid", (32, 32, 16))]
    level0 = plan["levels"][0]
    assert level0["map_k5"].shape == (1, caps[0], 125)
    assert torch.equal(level0["map_k3"], level0["map_k5"][:, :, [
        int(np.flatnonzero((tkm.kernel_offsets(5) == o).all(1))[0])
        for o in tkm.kernel_offsets(3)]])
