"""The port's 3D-VQA data (``data/threedvqa.py``, ``data/builders.py``) and
scoring (``eval/scorers.py``, ``eval/sqa3d_scoring.py``, ``cli/score.py``)
against the JAX package: samples and batches bit-equal on the same records,
feature files and seeds (the random subset of a scene above the
scene-token capacity included), ``question_id_int`` equal, and every scorer's
output equal on the same result JSON, for all four ``cli.score`` variants.
"""
import json

import numpy as np
import pytest
import torch

from situation3d_tpu.cli import score as jscore
from situation3d_tpu.data import builders as jbuilders
from situation3d_tpu.data import threedvqa as jdata
from situation3d_tpu.eval import scorers as jscorers
from situation3d_tpu.eval import sqa3d_scoring as jsqa
from situation3d_tpu_torch.cli import score as tscore
from situation3d_tpu_torch.data import builders as tbuilders
from situation3d_tpu_torch.data import threedvqa as tdata
from situation3d_tpu_torch.eval import scorers as tscorers
from situation3d_tpu_torch.eval import sqa3d_scoring as tsqa
from torch_port_util import assert_batches_equal, blip2_cfgs

torch.set_num_threads(1)

RECORDS = [
    {"scene_id": "scene0000_00", "question": "What is ON the table?!", "question_id": "a-1",
     "answers": ["cup", "a cup"]},
    {"scene_id": "scene0001_00", "question": "How many chairs are there", "question_id": 17,
     "answers": ["two"]},
    {"scene_id": "scene0000_00", "question": "Is the door (front) open?",
     "answers": ["no"]},                                   # no question_id: its index
    {"scene_id": "scene0009_00", "question": "Where is the bed?", "question_id": "gone",
     "answers": ["left"]},                                 # no feature files: filtered
    {"scene_id": "scene0001_00", "question": "Which color is the sofa",
     "question_id": "c/3", "question_id_int": 99, "answers": ["red", "dark red"]},
    {"scene_id": "scene0002_00", "question": "Can I sit on it", "question_id": "d4",
     "answers": ["yes"]},
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Feature files of three scenes: 80 points (above the capacity of 64,
    so the dataset draws a subset), 64 (exactly) and 30 (padded)."""
    root = tmp_path_factory.mktemp("features")
    rng = np.random.RandomState(0)
    for sid, n in (("scene0000_00", 80), ("scene0001_00", 64), ("scene0002_00", 30)):
        torch.save(torch.from_numpy(rng.randn(n, 48).astype(np.float32)), root / f"{sid}.pt")
        np.save(root / f"{sid}.npy", rng.randint(0, 256, (n, 3)).astype(np.int32))
    (root / "records.json").write_text(json.dumps(RECORDS))
    return root


def test_question_ids_and_questions_match_reference():
    for i, rec in enumerate(RECORDS + [{"question": "x"}]):
        assert tdata.question_id_int(rec, i) == jdata.question_id_int(rec, i)
        assert tdata.clean_question(rec["question"]) == jdata.clean_question(rec["question"])
    enc_t, enc_j = tdata.T5TextEncoder(vocab_size=128), jdata.T5TextEncoder(vocab_size=128)
    assert enc_j.hf is None          # no cached HF tokenizer: both take the hash branch
    for text in ("Question: what is on the table? Answer:", "", "a " * 40):
        for got, want in zip(enc_t.encode(text, 16), enc_j.encode(text, 16)):
            np.testing.assert_array_equal(got, want)
    ids = np.array([0, 5, 1, 0, 0])
    assert enc_t.decode(ids) == enc_j.decode(ids)


def _datasets(files, seed=3):
    jcfg, tcfg = blip2_cfgs()
    return (tdata.ThreeDVQADataset(tcfg.blip2, RECORDS, feature_dir=str(files), seed=seed),
            jdata.ThreeDVQADataset(jcfg.blip2, RECORDS, feature_dir=str(files), seed=seed))


def test_samples_and_batches_equal_reference(files):
    t, j = _datasets(files)
    assert len(t) == len(j) == 5 and t.train_pairs() == j.train_pairs()
    kept = []
    for i in range(len(t)):          # the 80-point scene draws a new subset each time
        got = t.sample(i, "a cup")
        assert_batches_equal(got, j.sample(i, "a cup"))
        kept.append(int(got["pc_mask"].sum()))
    assert kept == [64, 64, 64, 64, 30]
    for got, want in zip(tdata.train_batches(t, 3, seed=5, epochs=2),
                         jdata.train_batches(j, 3, seed=5, epochs=2)):
        assert_batches_equal(got, want)
    for got, want in zip(tdata.eval_batches(t, 4), jdata.eval_batches(j, 4)):
        assert_batches_equal(got, want)
    assert tdata.gold_answers(t) == jdata.gold_answers(j)


def test_synthetic_datasets_equal_reference():
    jcfg, tcfg = blip2_cfgs()
    t = tdata.synthetic_threedvqa(tcfg.blip2, 2, 3, n_points=100, seed=4)
    j = jdata.synthetic_threedvqa(jcfg.blip2, 2, 3, n_points=100, seed=4)
    assert t.records == j.records
    for got, want in zip(tdata.train_batches(t, 4, seed=0), jdata.train_batches(j, 4, seed=0)):
        assert_batches_equal(got, want)


def test_builders_match_reference(files, tmp_path, monkeypatch):
    """The yaml and the equivalent dict give the reference's datasets;
    relative storage paths resolve against the cache root; without the
    ``yaml`` package the port still reads the file written as JSON."""
    info = {"data_type": "features", "build_info": {
        "annotations": {"train": {"storage": ["records.json"]},
                        "val": {"storage": "records.json"}},
        "features": {"storage": str(files)}}}
    yml = tmp_path / "ds.yaml"
    yml.write_text(json.dumps({"datasets": {"3d_vqa": info}}))   # JSON is YAML
    jcfg, tcfg = blip2_cfgs()
    assert tbuilders.load_dataset_config(str(yml)) == jbuilders.load_dataset_config(str(yml))
    got = tbuilders.build_datasets_from_yaml(tcfg, str(yml), cache_root=str(files))
    want = jbuilders.build_datasets_from_yaml(jcfg, str(yml), cache_root=str(files))
    by_dict = tbuilders.ThreeDVQABuilder(tcfg, {"name": "3d_vqa", **info},
                                         cache_root=str(files)).build()
    assert sorted(got) == sorted(want) == sorted(by_dict) == ["train", "val"]
    for split in want:
        assert got[split].records == want[split].records == by_dict[split].records
        assert_batches_equal(got[split].sample(1), want[split].sample(1))
    for rel in ("a/b.json", "./a.json", "/abs/x"):
        assert tbuilders.get_cache_path(rel, "root") == jbuilders.get_cache_path(rel, "root")
    with_yaml = tbuilders.load_dataset_config(str(yml))
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)   # import yaml fails
    assert tbuilders.load_dataset_config(str(yml)) == with_yaml


PREDS = {"1": "chair", "2": "two chairs", "3": "Red.", "4": "<pad> left </s>", "5": "no",
         "6": "kitchen, table"}
GOLDS = {"1": ["chair", "sofa"], "2": ["two"], "3": ["red"], "4": ["left side"],
         "5": ["yes"], "6": ["kitchen table", "table"]}
QUESTIONS = {"1": "What is it?", "2": "How many chairs?", "3": "Which color is it",
             "4": "Where is the bed", "5": "Can I sit?", "6": "Is it a kitchen?"}


def test_scorers_match_reference():
    golds = {k: [v[0]] for k, v in GOLDS.items()}
    assert tscorers.score_all(PREDS, GOLDS) == jscorers.score_all(PREDS, GOLDS)
    assert tscorers.score_all(PREDS, golds) == jscorers.score_all(PREDS, golds)
    assert tsqa.score_results(PREDS, GOLDS, QUESTIONS) == jsqa.score_results(
        PREDS, GOLDS, QUESTIONS)


@pytest.mark.parametrize("variant", ["sqa3d", "scanqa", "3dllm", "3dmvvqa"])
@pytest.mark.parametrize("sharded", [False, True])
def test_cli_score_variants_match_reference(variant, sharded, tmp_path):
    """``cli.score`` on a result JSON (or the per-rank shards of a result
    directory) and an annotation list, against the JAX entry point."""
    results = [{"question_id": int(k), "answer": v} for k, v in PREDS.items()]
    if sharded:
        res = tmp_path / "result"
        res.mkdir()
        for r in range(2):
            (res / f"test_3_vqa_result_rank{r}.json").write_text(json.dumps(results[r::2]))
        where = ["--results", str(res), "--split", "test", "--epoch", "3"]
    else:
        (tmp_path / "vqa_result.json").write_text(json.dumps(results))
        where = ["--results", str(tmp_path / "vqa_result.json")]
    ann = [{"question_id": int(k), "question": QUESTIONS[k], "answers": GOLDS[k],
            "type": ["what", "counting", "color", "place", "yes/no", "object"][int(k) - 1]}
           for k in GOLDS]
    (tmp_path / "golds.json").write_text(json.dumps(ann))
    argv = ["--variant", variant, *where, "--golds", str(tmp_path / "golds.json"),
            "--all-buckets"]
    got = tscore.main(argv + ["--output", str(tmp_path / "t.json")])
    want = jscore.main(argv + ["--output", str(tmp_path / "j.json")])
    assert got == want and "All" in got
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
