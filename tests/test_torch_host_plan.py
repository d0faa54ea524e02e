"""Host-built UNet plans and the prefetcher: the port's own binding of
``native/voxelhash.cpp`` builds with g++ into ``situation3d_tpu_torch/_build/``;
its ``sparse_quantize``, ``downsample`` and ``kernel_map`` equal the
reference binding's, with the library and with the numpy fallbacks, and so
do ``fps`` and ``ball_query``; ``build_host_plan`` equals the reference's bit
for bit, overflowing levels included; against the port's device plan (plain
versions) each level holds the same coordinate set and every map agrees once
the rows are aligned; ``ThreadPrefetcher``, ``attach_host_plans``,
``make_train_pipeline`` and ``MultiIterLoader`` behave as the reference's."""
from pathlib import Path

import numpy as np
import pytest
import torch

from situation3d_tpu.data import prefetch as jprefetch
from situation3d_tpu.data import synthetic as jsyn
from situation3d_tpu.ops import native as jnative
from situation3d_tpu.sparse import host_plan as jhost
from situation3d_tpu_torch.data import prefetch as tprefetch
from situation3d_tpu_torch.data import synthetic as tsyn
from situation3d_tpu_torch.ops import native as tnative
from situation3d_tpu_torch.sparse import host_plan as thost
from situation3d_tpu_torch.sparse.kernel_map import kernel_offsets
from situation3d_tpu_torch.sparse.minkunet import build_unet_plan

from torch_port_util import assert_batches_equal, tiny_cfgs

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def built():
    assert jnative.ensure_built()
    assert tnative.ensure_built()


def _voxels(rng, B, cap, n, span, shuffle=True):
    coords = np.zeros((B, cap, 3), np.int32)
    mask = np.zeros((B, cap), bool)
    for b in range(B):
        c = np.unique(rng.randint(0, span, (n + 60, 3)), axis=0)[:n]
        if shuffle:            # first-occurrence order != key order
            rng.shuffle(c)
        coords[b, :len(c)], mask[b, :len(c)] = c, True
    return coords, mask


def _assert_plans_equal(got, want):
    assert len(got["levels"]) == len(want["levels"])
    for g, w in zip(got["levels"], want["levels"]):
        assert_batches_equal(g, w)
    assert_batches_equal(got["overflow"], want["overflow"])


def test_binding_builds_into_the_port_build_dir():
    path = tnative._lib_path()
    assert path.exists() and path.parent.parent == REPO / "situation3d_tpu_torch" / "_build"
    assert tnative.available() and tnative.SOURCE == REPO / "native" / "voxelhash.cpp"
    assert not any("native-" in p.name for p in (REPO / "native").iterdir())


@pytest.mark.parametrize("with_library", [True, False])
def test_native_ops_equal_the_reference_binding(rng, monkeypatch, with_library):
    if not with_library:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    coords = rng.randint(0, 12, (400, 3)).astype(np.int32)
    for got, want in zip(tnative.sparse_quantize(coords), jnative.sparse_quantize(coords)):
        np.testing.assert_array_equal(got, want)
    fine = np.unique(rng.randint(0, 14, (90, 3)), axis=0).astype(np.int32)
    rng.shuffle(fine)
    for stride in (2, 4):
        np.testing.assert_array_equal(tnative.downsample(fine, stride),
                                      jnative.downsample(fine, stride))
    coarse = tnative.downsample(fine, 2)
    cases = [(fine, 1, fine, kernel_offsets(3), 1),            # k3 on one level
             (fine, 1, fine, kernel_offsets(5), 1),            # k5
             (fine, 1, coarse, kernel_offsets(2), 1),          # down map
             (coarse, 2, fine, -kernel_offsets(2), 1),         # up map (parity misses)
             (coarse, 2, coarse, kernel_offsets(3), 2)]        # k3 at stride 2
    for args in cases:
        got, want = tnative.kernel_map(*args), jnative.kernel_map(*args)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    xyz = rng.randn(300, 3).astype(np.float32)
    np.testing.assert_array_equal(tnative.fps(xyz, 24), jnative.fps(xyz, 24))
    if with_library:
        np.testing.assert_array_equal(tnative.ball_query(xyz, xyz[:20], 0.6, 8),
                                      jnative.ball_query(xyz, xyz[:20], 0.6, 8))
    else:
        with pytest.raises(NotImplementedError):
            tnative.ball_query(xyz, xyz[:20], 0.6, 8)


@pytest.mark.parametrize("caps", [(256, 256, 256, 128, 64),    # nothing dropped
                                  (256, 96, 48, 24, 12)])       # levels 1-4 overflow
def test_build_host_plan_is_bit_equal(rng, caps):
    coords, mask = _voxels(rng, 3, 256, 200, 24)
    mask[2, 150:] = False                       # a sample with fewer voxels
    got = thost.build_host_plan(coords, mask, caps)
    want = jhost.build_host_plan(coords, mask, caps)
    _assert_plans_equal(got, want)
    assert (got["overflow"]["voxels_dropped"] > 0).any() == (caps[1] < 256)
    assert sorted(got["levels"][0]) == ["coords", "map_k3", "map_k5", "map_up", "mask"]
    assert got["levels"][4]["map_down"].shape == (3, caps[4], 8)


def test_host_plan_matches_the_device_plan_as_sets_and_permuted_maps(rng):
    """The port's device plan (``build_unet_plan``, plain versions on the
    CPU): the same coordinate set on every level, every map equal once the
    rows are aligned; a changed entry or an overflowing level is seen."""
    caps = (256, 256, 256, 128, 64)
    coords, mask = _voxels(rng, 2, 256, 200, 24)
    host = thost.build_host_plan(coords, mask, caps)
    dev = build_unet_plan(torch.from_numpy(coords), torch.from_numpy(mask), caps,
                          (64, 64, 64), device="cpu")
    levels, problems = thost.compare_with_device_plan(host, dev)
    assert levels == [0, 1, 2, 3, 4] and problems == []
    # the orders differ from level 1 on (first occurrence vs key order)
    assert not np.array_equal(host["levels"][1]["coords"], dev["levels"][1]["coords"].numpy())
    host["levels"][2]["map_up"][1, 5, 3] += 1
    _, problems = thost.compare_with_device_plan(host, dev)
    assert problems == ["sample 1 level 2 map_up: maps differ after aligning rows (1 entries)"]
    small = (256, 128, 64, 32, 16)              # level 1 overflows in both plans
    host = thost.build_host_plan(coords, mask, small)
    dev = build_unet_plan(torch.from_numpy(coords), torch.from_numpy(mask), small,
                          (64, 64, 64), device="cpu")
    assert thost.compare_with_device_plan(host, dev) == ([0], [])


def test_thread_prefetcher_keeps_order_and_passes_errors_on():
    items = list(range(10))
    assert list(tprefetch.ThreadPrefetcher(iter(items))) == items

    def boom():
        yield 1
        raise ValueError("boom")

    it = iter(tprefetch.ThreadPrefetcher(boom()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_attach_host_plans_and_the_train_pipeline_equal_the_reference(rng):
    caps = (128, 64, 32, 16, 8)
    coords, mask = _voxels(rng, 2, 128, 60, 12)
    batches = [{"voxel_coords": coords, "voxel_mask": mask, "x": np.zeros(2)}]
    [got] = list(tprefetch.attach_host_plans(iter(batches), caps))
    [want] = list(jprefetch.attach_host_plans(iter(batches), caps))
    _assert_plans_equal(got.pop("plan"), want.pop("plan"))
    assert_batches_equal(got, want)

    opts = ("data.voxel_capacity=512", "sparse.capacities=512,256,128,64,32")
    jcfg, tcfg = tiny_cfgs(opts)
    kw = dict(n_scenes=1, per_scene=4, n_points=2000)
    pipes = (tprefetch.make_train_pipeline(tsyn.make_synthetic_dataset(tcfg, **kw), 2,
                                           tcfg.sparse.capacities, seed=3, epochs=1),
             jprefetch.make_train_pipeline(jsyn.make_synthetic_dataset(jcfg, **kw), 2,
                                           jcfg.sparse.capacities, seed=3, epochs=1))
    n = 0
    for got, want in zip(*pipes, strict=True):
        _assert_plans_equal(got.pop("plan"), want.pop("plan"))
        assert_batches_equal(got, want)
        n += 1
    assert n == 2
    plain = list(tprefetch.make_train_pipeline(tsyn.make_synthetic_dataset(tcfg, **kw), 2,
                                               epochs=1))
    assert len(plain) == 2 and "plan" not in plain[0]


def test_multi_iter_loader_and_repeat_iterator_equal_the_reference():
    def loaders(mod):
        return [mod.repeat_iterator(lambda: iter(["a", "b"])),
                mod.repeat_iterator(lambda: iter(["c"]))]

    got = tprefetch.MultiIterLoader(loaders(tprefetch), ratios=[3, 1], seed=0)
    want = jprefetch.MultiIterLoader(loaders(jprefetch), ratios=[3, 1], seed=0)
    draws = [next(got) for _ in range(400)]
    assert draws == [next(want) for _ in range(400)]
    assert 0.65 < (draws.count("a") + draws.count("b")) / 400 < 0.85
    even = tprefetch.MultiIterLoader(loaders(tprefetch), seed=1)
    assert iter(even) is even and {next(even) for _ in range(50)} == {"a", "b", "c"}
