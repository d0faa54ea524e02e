"""The port's numpy data code of the OpenScene path against the reference's,
bit for bit on the same seed and files: every augmentation
(``data/augmentation.py``, each draw from the given ``RandomState`` in the
same order), ``Point3DLoader`` and ``FusedFeatureLoader``
(``data/openscene_loader.py``; with and without augmentation, colour input,
``eval_all``, a scene with two feature files, capacity overflow) and the
ScanNet scan readers (``data/scannet_preprocess.py``) on small files written
here."""
import json
import os

import numpy as np
import pytest
import torch

from situation3d_tpu.data import augmentation as jaug
from situation3d_tpu.data import openscene_loader as jload
from situation3d_tpu.data import scannet_preprocess as jscan
from situation3d_tpu_torch.data import augmentation as taug
from situation3d_tpu_torch.data import openscene_loader as tload
from situation3d_tpu_torch.data import scannet_preprocess as tscan

from torch_port_util import assert_batches_equal

torch.set_num_threads(1)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _colors(seed, n=300):
    rng = np.random.RandomState(seed)
    c = rng.rand(n, 3) * 255
    c[:5] = [[0, 0, 0], [255, 255, 255], [10, 10, 10], [255, 0, 0], [0, 128, 255]]
    return c


@pytest.mark.parametrize("name,args", [
    ("chromatic_translation", (0.1,)),
    ("chromatic_auto_contrast", (True,)),
    ("chromatic_auto_contrast", (False, 0.3)),
    ("chromatic_jitter", (0.05,)),
    ("hue_saturation_translation", (0.5, 0.2)),
    ("random_horizontal_flip", (2,)),
    ("random_horizontal_flip", (0, 0.9)),
    ("elastic_distortion", (0.2, 0.4)),
    ("elastic_distortion", (0.8, 1.6)),
])
def test_augmentation_equals_reference(name, args):
    """Same output, and the generator left in the same state."""
    x = (np.random.RandomState(1).rand(400, 3) * [3.0, 2.0, 1.5] if name in (
        "random_horizontal_flip", "elastic_distortion") else _colors(2)).astype(np.float32)
    rj, rt = np.random.RandomState(7), np.random.RandomState(7)
    want = getattr(jaug, name)(x.copy(), rj, *args)
    got = getattr(taug, name)(x.copy(), rt, *args)
    _same(got, want)
    assert rt.rand() == rj.rand()


def test_hsv_round_trip_equals_reference():
    c = _colors(3)
    _same(taug.rgb_to_hsv(c), jaug.rgb_to_hsv(c))
    _same(taug.hsv_to_rgb(taug.rgb_to_hsv(c)), jaug.hsv_to_rgb(jaug.rgb_to_hsv(c)))


def _write_scenes(root, n_scenes=3, n_points=1500):
    """ScanNet-style ``.pth`` rooms (one of them larger than the capacity
    below) with -100 labels, and fused features: scene 0 has two feature
    files, scene 2 none (the feature loader drops it)."""
    rng = np.random.RandomState(11)
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, "3d", split), exist_ok=True)
    os.makedirs(os.path.join(root, "feat"), exist_ok=True)
    for i in range(n_scenes):
        n = n_points * (2 if i == 1 else 1)
        locs = (rng.rand(n, 3) * [4.0, 3.0, 2.0]).astype(np.float32)
        labels = rng.randint(0, 20, n).astype(np.int64)
        labels[rng.rand(n) < 0.1] = -100
        scene = (locs, rng.uniform(-1, 1, (n, 3)).astype(np.float32), labels)
        for split in ("train", "val"):
            torch.save(scene, os.path.join(root, "3d", split, f"scene{i:04d}_00_vh_clean_2.pth"))
        for k in range({0: 2, 1: 1, 2: 0}[i]):
            seen = rng.rand(n) < 0.6
            torch.save({"feat": torch.from_numpy(rng.randn(int(seen.sum()), 8).astype(
                np.float16)), "mask_full": torch.from_numpy(seen)},
                os.path.join(root, "feat", f"scene{i:04d}_00_{k}.pt"))
    return os.path.join(root, "3d"), os.path.join(root, "feat")


LOADER_CASES = [dict(split="train", aug_enabled=False),
                dict(split="train", aug_enabled=True, input_color=True),
                dict(split="val", eval_all=True),
                dict(split="val", eval_all=True, aug_enabled=True)]
LOADER_IDS = ["plain", "augmented_colour", "eval_all", "eval_all_augmented"]


@pytest.mark.parametrize("kw", LOADER_CASES, ids=LOADER_IDS)
def test_point_loader_equals_reference(tmp_path, kw):
    d3, _ = _write_scenes(str(tmp_path))
    opts = dict(voxel_size=0.05, capacity=1200, point_capacity=4000, seed=3, loop=2, **kw)
    jl, tl = jload.Point3DLoader(d3, **opts), tload.Point3DLoader(d3, **opts)
    assert len(tl) == len(jl) == 6
    for i in (0, 1, 5, 1):                 # a cached scene read again
        assert_batches_equal(tl[i], jl[i])
    assert tl[1]["overflow"] > 0 and (tl[0]["labels"] == tload.IGNORE_LABEL).any()


@pytest.mark.parametrize("kw", LOADER_CASES, ids=LOADER_IDS)
def test_fused_feature_loader_equals_reference(tmp_path, kw):
    d3, feat = _write_scenes(str(tmp_path))
    opts = dict(voxel_size=0.05, capacity=1200, point_capacity=4000, seed=4, **kw)
    jl, tl = jload.FusedFeatureLoader(d3, feat, **opts), tload.FusedFeatureLoader(d3, feat, **opts)
    assert tl.list_occur == jl.list_occur == [2, 1]
    for i in range(6):                     # scene 0 draws its occurrence in training
        assert_batches_equal(tl[i % 2], jl[i % 2])
    item = tl[0]
    assert item["feat_3d"].shape == (1200, 8) and item["feat_mask"].any()


def test_loaders_raise_on_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        tload.Point3DLoader(str(tmp_path))
    d3, _ = _write_scenes(str(tmp_path))
    os.makedirs(tmp_path / "nofeat")
    with pytest.raises(FileNotFoundError):
        tload.FusedFeatureLoader(d3, str(tmp_path / "nofeat"))


def _write_scan(root):
    """A label map, a meta file with an axis alignment, an aggregation and a
    segmentation of a 40-vertex mesh."""
    tsv = os.path.join(root, "labels.tsv")
    with open(tsv, "w") as fh:
        fh.write("id\traw_category\tcategory\tnyu40id\n")
        for i, (raw, nyu) in enumerate((("chair", 5), ("office chair", 5), ("table", 7),
                                        ("door", 8))):
            fh.write(f"{i + 1}\t{raw}\t{raw}\t{nyu}\n")
    meta = os.path.join(root, "scene.txt")
    aa = np.eye(4)
    aa[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    aa[:3, 3] = [1.25, -0.5, 0.125]
    with open(meta, "w") as fh:
        fh.write("colorHeight = 968\naxisAlignment = " + " ".join(map(str, aa.ravel())) + "\n")
    seg = os.path.join(root, "scene.segs.json")
    segs = [i // 5 for i in range(40)]
    with open(seg, "w") as fh:
        json.dump({"segIndices": segs}, fh)
    agg = os.path.join(root, "scene.aggregation.json")
    with open(agg, "w") as fh:
        json.dump({"segGroups": [{"objectId": 0, "label": "chair", "segments": [0, 2]},
                                 {"objectId": 1, "label": "table", "segments": [5]},
                                 {"objectId": 2, "label": "door", "segments": [99]}]}, fh)
    return tsv, meta, seg, agg


def test_scan_readers_equal_reference(tmp_path):
    tsv, meta, seg, agg = _write_scan(str(tmp_path))
    assert tscan.read_label_mapping(tsv) == jscan.read_label_mapping(tsv)
    assert tscan.read_label_mapping(tsv, "id", "nyu40id") == \
        jscan.read_label_mapping(tsv, "id", "nyu40id")
    _same(tscan.read_axis_align_matrix(meta), jscan.read_axis_align_matrix(meta))
    _same(tscan.read_axis_align_matrix(str(tmp_path / "none.txt")), np.eye(4))
    assert tscan.load_segmentation(seg) == jscan.load_segmentation(seg)
    assert tscan.load_aggregation(agg) == jscan.load_aggregation(agg)
    seg_to_verts = tscan.load_segmentation(seg)
    obj_to_segs, obj_to_name = tscan.load_aggregation(agg)
    mapping = tscan.read_label_mapping(tsv)
    obj_to_label = {o: mapping[n] for o, n in obj_to_name.items()}
    verts = np.random.RandomState(5).rand(40, 6).astype(np.float32)
    for aa in (None, tscan.read_axis_align_matrix(meta)):
        got = tscan.export_scene(verts, seg_to_verts, obj_to_segs, obj_to_label, aa)
        want = jscan.export_scene(verts, seg_to_verts, obj_to_segs, obj_to_label, aa)
        assert_batches_equal(got, want)
    assert got["instance_bboxes"].shape == (2, 7)        # the door's segment is empty
