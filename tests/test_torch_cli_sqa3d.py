"""SIG3D trained and evaluated from SQA3D-layout files through the port's
entry points, on the CPU, and the slice as a whole against the reference.

- ``cli.train --task sqa3d`` (2 steps) reads the files, writes the
  reference's answer vocabulary, ``info.json`` and a checkpoint; ``cli.eval``
  restores that step and evaluates plain, through the scene cache, and with
  ``--segmentation --visualize``: finite metrics, the PLY / OBJ / PNG files.
- the first batch of the files goes through both packages' datasets (equal
  bit for bit) and SIG3D (the reference's weights and draws, one jitted
  reference call at full float32 matmul precision): loss and
  ``answer_scores`` agree within 1e-4.
- segmentation metrics, visualization files (byte for byte) and
  ``MultimodalClassificationTask.after_evaluation`` equal the reference's on
  the same inputs; ``--synthetic`` builds the reference's datasets (2 x 16
  train records, 1 x 8 val); the 3D-LLM tasks say which slice they wait for.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from situation3d_tpu.data import sqa3d as jsqa
from situation3d_tpu.data import vocab as jvocab
from situation3d_tpu.eval import segmentation as jseg
from situation3d_tpu.eval import visualization as jvis
from situation3d_tpu.models import sig3d as jsig
from situation3d_tpu.train import losses as jlosses
from situation3d_tpu.train import logging as jlog
from situation3d_tpu.train import tasks as jtasks
from situation3d_tpu_torch.cli import eval as cli_eval
from situation3d_tpu_torch.cli import infer as cli_infer
from situation3d_tpu_torch.cli import train as cli_train
from situation3d_tpu_torch.data import sqa3d as tsqa
from situation3d_tpu_torch.data import vocab as tvocab
from situation3d_tpu_torch.eval import segmentation as tseg
from situation3d_tpu_torch.eval import visualization as tvis
from situation3d_tpu_torch.models import sig3d as tsig
from situation3d_tpu_torch.train import logging as tlog
from situation3d_tpu_torch.train import tasks as ttasks
from situation3d_tpu_torch.train.losses import get_loss

from torch_port_util import (TINY, assert_batches_equal, jax_sample_draws, load_into_port,
                             random_variables, t2n, tiny_cfgs, write_small_sqa3d)

torch.set_num_threads(1)
ATOL = 1e-4
B = 2


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_small_sqa3d(tmp_path_factory.mktemp("sqa3d"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory, files):
    tmp = tmp_path_factory.mktemp("run")
    opts = [*TINY, "data.voxel_capacity=512", *files, f"train.batch_size={B}",
            "train.epochs=1", "train.log_every_steps=1", "train.val_every_steps=1000",
            f"train.ckpt_dir={tmp}/ckpt", f"log.log_dir={tmp}/logs", f"eval.batch_size={B}"]
    metrics = cli_train.main(["--task", "sqa3d", "--max-steps", "2", "--device", "cpu",
                              "--output", str(tmp / "out"), "--options", *opts])
    return dict(tmp=tmp, opts=opts, metrics=metrics)


def test_cli_train_reads_the_files(trained):
    tmp, out = trained["tmp"], trained["tmp"] / "out"
    info = json.load(open(out / "info.json"))
    assert info == {"task": "sqa3d", "num_train": 8, "num_val": 4, "num_answers": 12,
                    "device": "cpu"}
    jcfg, _ = tiny_cfgs(trained["opts"][len(TINY):])
    counter = jvocab.load_answer_counter(jcfg.data.answer_counter)
    want = jvocab.build_answer_vocab(counter, jcfg.data.answer_min_freq,
                                     jcfg.data.num_answers).itos_list
    assert json.load(open(out / "answer_vocab.json")) == want
    rows = [json.loads(x) for x in open(tmp / "logs" / "metrics.jsonl")]
    steps = [r for r in rows if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["time/fetch"] > 0 for r in steps)
    assert os.path.exists(tmp / "ckpt" / "step_2.pt")
    assert trained["metrics"]["num_samples"] == 4
    assert 0.0 <= trained["metrics"]["answer_acc_at1"] <= 1.0


@pytest.mark.parametrize("flags", [[], ["--scene-cache"], ["--segmentation", "--visualize"]])
def test_cli_eval_restores_the_checkpoint(trained, flags):
    out = trained["tmp"] / ("eval" + "".join(flags))
    res = cli_eval.main(["--task", "sqa3d", "--checkpoint", "latest", "--device", "cpu",
                         "--output", str(out), "--options", *trained["opts"], *flags])
    assert res["step"] == 2 and res["num_questions"] == 4
    metrics = json.load(open(out / "metrics.json"))
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    for k in ("answer_acc_at1", "answer_acc_at10", "answer_acc_breakdown_what"):
        assert 0.0 <= metrics[k] <= 1.0
    if "--segmentation" in flags:
        assert 0.0 <= metrics["seg_mIoU"] <= 1.0 and 0.0 <= metrics["seg_accuracy"] <= 1.0
        assert len([k for k in metrics if k.startswith("seg_iou/")]) == 20
        for i in range(2):
            for suffix in ("_points.ply", "_situation.obj", "_render.png"):
                assert (out / f"scene{i}{suffix}").stat().st_size > 0
            assert (out / "images" / f"eval_scene{i}_2.png").exists()
    else:
        assert "seg_mIoU" not in metrics


def test_slice_as_a_whole_matches_the_reference(files):
    """Both packages' datasets, batch iterators and SIG3D models on the
    files' first training batch (plans built on the device on both sides)."""
    jcfg, tcfg = tiny_cfgs(("data.voxel_capacity=512", *files))
    batches = []
    for cfg, sqa, vocab in ((jcfg, jsqa, jvocab), (tcfg, tsqa, tvocab)):
        counter = vocab.load_answer_counter(cfg.data.answer_counter)
        voc = vocab.build_answer_vocab(counter, 1, cfg.data.num_answers)
        batch = next(sqa.batch_iterator(sqa.SQA3DDataset(cfg, "train", voc, counter), B,
                                        seed=cfg.train.seed))
        batches.append({k: v for k, v in batch.items() if k not in ("question_id",)})
    jbatch, tbatch = batches
    assert_batches_equal(tbatch, jbatch)
    jmodel = jsig.SIG3D(jcfg, num_answers=12)
    variables = random_variables(jmodel, jbatch, np.random.RandomState(1))
    key = jax.random.PRNGKey(4)
    tag = jcfg.model.situation_loss_tag

    def run(v, b, k):
        out = jmodel.apply(v, b, train=False, rngs={"sample": k})
        return out["answer_scores"], jlosses.get_loss(out, b, jcfg.loss, tag)[0]

    with jax.default_matmul_precision("highest"):
        scores, loss = (np.asarray(x) for x in jax.jit(run)(variables, jbatch, key))
    draws = jax_sample_draws(jmodel, variables, key, B, tcfg.sparse.capacities[-1],
                             tcfg.model.num_scene_tokens)
    model = load_into_port(tsig.SIG3D(tcfg, 12, device="cpu"), variables)
    with torch.no_grad():
        out = model(tbatch, sample_draws=draws)
        tloss = float(get_loss(out, model._to_device(tbatch), tcfg.loss, tag)[0])
    assert float(np.abs(scores).max()) > 1e-3
    np.testing.assert_allclose(t2n(out["answer_scores"]), scores, atol=ATOL, rtol=0)
    assert np.isfinite(loss) and abs(tloss - float(loss)) <= ATOL * max(1.0, abs(float(loss)))


def test_segmentation_metrics_equal_the_reference():
    rng = np.random.RandomState(2)
    gt = rng.randint(0, 20, 5000)
    gt[rng.rand(5000) < 0.05] = 255
    pred = np.where(rng.rand(5000) < 0.6, gt, rng.randint(0, 20, 5000)) % 20
    pred[:40] = 3                                    # class 19 may be absent from pred
    for n in (20, 12):
        np.testing.assert_array_equal(tseg.confusion_matrix(pred, gt, n),
                                      jseg.confusion_matrix(pred, gt, n))
    conf = tseg.confusion_matrix(pred, gt, 20)
    conf[7] = 0
    conf[:, 7] = 0                                   # a class nobody has: NaN IoU
    (tm, ti), (jm, ji) = tseg.miou_from_confusion(conf), jseg.miou_from_confusion(conf)
    assert tm == jm and np.isnan(ti[7])
    np.testing.assert_array_equal(ti, ji)
    got, want = tseg.evaluate(pred, gt), jseg.evaluate(pred, gt)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))
    feats = rng.randn(300, 16).astype(np.float32)
    tf = rng.randn(20, 16).astype(np.float32)
    np.testing.assert_array_equal(tseg.segment_points(feats, tf), jseg.segment_points(feats, tf))

    def encode(texts):
        return np.stack([np.cos(np.arange(16) * (len(t) + i)) for i, t in enumerate(texts)])

    np.testing.assert_array_equal(tseg.precompute_text_features(encode),
                                  jseg.precompute_text_features(encode))
    assert tseg.SCANNET_LABELS_20 == jseg.SCANNET_LABELS_20
    np.testing.assert_array_equal(tseg.SCANNET_PALETTE, jseg.SCANNET_PALETTE)


def test_visualization_files_equal_the_reference(tmp_path):
    rng = np.random.RandomState(3)
    pts = (rng.rand(400, 3) * [4, 3, 2]).astype(np.float32)
    gt = np.array([1.0, 1.5, 0.5, 0, 0, 0.38268343, 0.92387953])
    pred = np.array([1.2, 1.1, 0.4, 0.1, 0.0, -0.5, 0.8])
    att = rng.rand(400)
    files = {}
    for name, mod in (("t", tvis), ("j", jvis)):
        d = tmp_path / name
        d.mkdir()
        mod.write_ply_points(str(d / "plain.ply"), pts)
        mod.write_ply_points(str(d / "color.ply"), pts, mod.activation_colors(att))
        v, f = mod.create_arrow([0, 0, 0], [1, 2, 0.5])
        mod.write_obj_mesh(str(d / "arrow.obj"), v, f)
        mod.situation_arrows_obj(str(d / "gt.obj"), gt)
        mod.write_png(str(d / "top.png"), mod.render_topdown(pts, gt_pose=gt, pred_pose=pred))
        mod.write_png(str(d / "empty.png"), mod.render_topdown(np.zeros((0, 3))))
        mod.export_scene_visualization(str(d / "scene"), "s0", pts, att, gt, pred)
        log = (tlog if name == "t" else jlog).MetricWriter(str(d / "log"))
        log.write_image("eval/scene0", mod.render_topdown(pts, splat=2), step=3)
        log.close()
        files[name] = {str(p.relative_to(d)): p.read_bytes()
                       for p in sorted(d.rglob("*")) if p.is_file() and p.suffix != ".jsonl"}
    assert len(files["t"]) == 10 and files["t"].keys() == files["j"].keys()
    for k in files["j"]:
        assert files["t"][k] == files["j"][k], k


def test_multimodal_classification_after_evaluation_equals_the_reference():
    results = [{"question_id": q, "prediction": p, "target": t}
               for q, p, t in [(1, 3, 3), (2, 0, 1), (1, 5, 5), (3, 2, 2), (2, 1, 1), (4, 0, 7)]]
    for rs in (results, results[:1], []):
        assert ttasks.MultimodalClassificationTask.after_evaluation(rs) == \
            jtasks.MultimodalClassificationTask.after_evaluation(rs)


def test_multimodal_classification_valid_step_runs():
    _, tcfg = tiny_cfgs(("data.voxel_capacity=512",))
    task = ttasks.setup_task("multimodal_classification", tcfg, synthetic=True, device="cpu")
    ds = task.build_datasets()["val"]
    batch = next(tsqa.batch_iterator(ds, B, shuffle=False))
    res = task.valid_step(task.build_model(), batch)
    assert [r["question_id"] for r in res] == batch["question_id"].tolist()
    assert all(0 <= r["prediction"] < 12 for r in res)
    assert [r["target"] for r in res] == batch["answer_cat"].tolist()


def test_synthetic_flag_builds_the_reference_datasets():
    """``--synthetic`` (and a missing ``data.sqa_train``) means the
    reference's synthetic datasets, served through ``SQA3DDataset``."""
    jcfg, tcfg = tiny_cfgs(("data.voxel_capacity=512",))
    for synthetic in (True, False):          # False: the default path has no file here
        got = ttasks.setup_task("sqa3d", tcfg, synthetic=synthetic, device="cpu").build_datasets()
        want = jtasks.setup_task("sqa3d", jcfg, synthetic=synthetic).build_datasets()
        assert (len(got["train"]), len(got["val"])) == (len(want["train"]), len(want["val"])) \
            == (32, 8)
        assert isinstance(got["train"], tsqa.SQA3DDataset)
        for split in ("train", "val"):
            assert_batches_equal(next(tsqa.batch_iterator(got[split], 4, seed=5)),
                                 next(jsqa.batch_iterator(want[split], 4, seed=5)))


@pytest.mark.parametrize("name", ["3d_vqa", "stage1", "captioning", "retrieval", "dialogue",
                                  "vqa_reading_comprehension"])
def test_3d_llm_tasks_name_the_blip2_slice(name):
    """The 3D-LLM's tasks are ported, each on the task's device: the
    generative ones (Blip2T5) and ``retrieval`` (the stage-1 Q-Former).
    ``stage1`` is no task in either package's registry: ``cli.train --task
    stage1`` reads the ``3d_vqa`` datasets."""
    jcfg, tcfg = tiny_cfgs()
    if name == "stage1":
        with pytest.raises(KeyError, match="stage1"):
            ttasks.setup_task(name, tcfg)
        with pytest.raises(KeyError, match="stage1"):
            jtasks.setup_task(name, jcfg)
        return
    task = ttasks.setup_task(name, tcfg, device="cpu")
    want = ttasks.RetrievalTask if name == "retrieval" else ttasks.ThreeDVQATask
    assert isinstance(task, want) and task.device == "cpu"
    assert type(jtasks.setup_task(name, jcfg)).__name__ == type(task).__name__


def test_cli_infer_sqa3d_answers_from_the_checkpoint(trained, files, capsys):
    """``cli.infer --task sqa3d``: one scene, a situation and a question give
    one of the run's answers from its checkpoint."""
    tmp = trained["tmp"]
    vocab = json.load(open(tmp / "out" / "answer_vocab.json"))
    answer = cli_infer.main(["--task", "sqa3d", "--scene", "scene0001_00",
                             "--question", "What is behind me?",
                             "--checkpoint", str(tmp / "ckpt"),
                             "--answer-vocab", str(tmp / "out" / "answer_vocab.json"),
                             "--device", "cpu", "--options", *trained["opts"]])
    assert answer in vocab
    assert capsys.readouterr().out.splitlines()[-2:] == ["Q: What is behind me?",
                                                         f"A: {answer}"]
