"""The 3D-LLM through the port's entry points on the CPU (``--device cpu``,
the tiny width of ``torch_port_util.BLIP2_TINY``): ``cli.train --task
3d_vqa --synthetic``, ``cli.eval`` from its checkpoint, ``cli.infer --task
3d_vqa`` on feature files, ``cli.score`` on the answers, the tasks'
``valid_step``; and the slice as a whole against the JAX package: the
synthetic val set through ``evaluate_generation`` and the scorers with the
same weights gives the same answers and the same scores.

Tolerances: the dialogue loss within 1e-4 of JAX's; answers, result JSON
and scores equal.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from situation3d_tpu.data import threedvqa as jdata
from situation3d_tpu.eval.sqa3d_scoring import score_results as j_score_results
from situation3d_tpu.models import blip2_t5 as jb2
from situation3d_tpu.train import blip2_trainer as jtrainer
from situation3d_tpu.train import tasks as jtasks
from situation3d_tpu_torch.cli import eval as cli_eval
from situation3d_tpu_torch.cli import infer as cli_infer
from situation3d_tpu_torch.cli import score as cli_score
from situation3d_tpu_torch.cli import train as cli_train
from situation3d_tpu_torch.ckpt_compat.blip2 import convert_blip2
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.data import threedvqa as tdata
from situation3d_tpu_torch.eval.sqa3d_scoring import score_results
from situation3d_tpu_torch.models import blip2_t5 as tb2
from situation3d_tpu_torch.train import blip2_trainer as ttrainer
from situation3d_tpu_torch.train import tasks as ttasks
from torch_port_util import (BLIP2_TINY, assert_batches_equal, blip2_batch, blip2_cfgs,
                             fake_blip2_state_dict, random_variables_of, to_numpy_tree)

torch.set_num_threads(1)
RTOL = 1e-4


def _jit(fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli.train --task 3d_vqa --synthetic`` for 3 steps at batch 4: 24
    training pairs, 6 steps an epoch, so one validation (at the step limit)
    with its checkpoint and trainable-only ``.npz``."""
    root = tmp_path_factory.mktemp("blip2")
    opts = [*BLIP2_TINY, "train.batch_size=4", "eval.batch_size=4", "eval.max_gen_len=4",
            f"train.ckpt_dir={root / 'ckpt'}", f"log.log_dir={root / 'logs'}",
            "train.log_every_steps=1", "train.epochs=5", "train.lr=1e-3"]
    out = cli_train.main(["--task", "3d_vqa", "--synthetic", "--max-steps", "3",
                          "--device", "cpu", "--output", str(root / "run"), "--options", *opts])
    return {"root": root, "opts": opts, "out": out}


def test_cli_train_3d_vqa_on_the_cpu(trained):
    root, out = trained["root"], trained["out"]
    # synthetic_threedvqa(2 scenes x 8 records, 1-2 answers each): 24 pairs
    assert out["step"] == 3 and out["num_train_pairs"] == 24 and out["num_val"] == 4
    assert 0.0 <= out["final"]["EM"] <= 1.0
    rows = [json.loads(x) for x in open(root / "logs" / "metrics.jsonl")]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert [r["step"] for r in rows if "val/em" in r] == [3]
    assert sorted(os.listdir(root / "ckpt")) == [
        "checkpoint_best_trainable.npz", "metrics.json", "step_3.pt"]
    results = json.load(open(root / "run" / "results" / "vqa_result.json"))
    assert len(results) == 4 and all(r["answer"].startswith("tok") or r["answer"] == ""
                                     for r in results)
    assert json.load(open(root / "run" / "config.json"))["blip2"]["t5"]["d_model"] == 64


def test_cli_eval_infer_and_score_from_the_checkpoint(trained, tmp_path, capsys):
    root, opts = trained["root"], trained["opts"]
    got = cli_eval.main(["--task", "3d_vqa", "--synthetic", "--device", "cpu",
                         "--checkpoint", str(root / "ckpt"), "--output", str(tmp_path / "ev"),
                         "--options", *opts])
    assert got["step"] == 3 and got["num_questions"] == 4
    scores = json.load(open(tmp_path / "ev" / "scores.json"))
    assert scores == got["scores"] and scores["All"]["count"] == 4
    results = json.load(open(tmp_path / "ev" / "vqa_result.json"))
    assert results == json.load(open(tmp_path / "ev" / "vqa_result_rank0.json"))
    # the same weights through the trainable-only .npz give the same answers
    again = cli_eval.main(["--task", "3d_vqa", "--synthetic", "--device", "cpu",
                           "--trainable-checkpoint",
                           str(root / "ckpt" / "checkpoint_best_trainable.npz"),
                           "--output", str(tmp_path / "ev2"), "--options", *opts])
    assert again["scores"] == got["scores"]
    assert json.load(open(tmp_path / "ev2" / "vqa_result.json")) == results

    # cli.score on that result file, golds as an annotation list
    val = tdata.synthetic_threedvqa(cli_eval.load_config(None, opts).blip2, 1, 4, seed=1)
    ann = [{"question_id": tdata.question_id_int(r, i), "question": r["question"],
            "answers": r["answers"]} for i, r in enumerate(val.records)]
    (tmp_path / "golds.json").write_text(json.dumps(ann))
    scored = cli_score.main(["--variant", "sqa3d", "--results",
                             str(tmp_path / "ev" / "vqa_result.json"),
                             "--golds", str(tmp_path / "golds.json")])
    assert scored == scores

    # cli.infer on one scene's feature files
    rng = np.random.RandomState(0)
    torch.save(torch.from_numpy(rng.randn(90, 48).astype(np.float32)), tmp_path / "s.pt")
    np.save(tmp_path / "s.npy", rng.randint(0, 256, (90, 3)).astype(np.int32))
    capsys.readouterr()
    answer = cli_infer.main(["--task", "3d_vqa", "--pc-feat", str(tmp_path / "s.pt"),
                             "--pc", str(tmp_path / "s.npy"), "--question", "What is this?",
                             "--checkpoint", str(root / "ckpt"), "--device", "cpu",
                             "--visualize", "--visualize-points", "40",
                             "--visualize-out", str(tmp_path / "tsne.png"),
                             "--options", *opts])
    printed = capsys.readouterr().out.splitlines()
    assert printed[-2:] == ["Q: what is this?", f"A: {answer}"]
    assert (tmp_path / "tsne.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_eval_names_what_it_cannot_read(trained, tmp_path):
    orbax_like = tmp_path / "orbax"
    (orbax_like / "100").mkdir(parents=True)
    argv = ["--task", "3d_vqa", "--synthetic", "--device", "cpu", "--output",
            str(tmp_path / "ev"), "--options", *trained["opts"]]
    with pytest.raises(RuntimeError, match="orbax"):
        cli_eval.main([*argv, "--checkpoint", str(orbax_like)])
    with pytest.raises(FileNotFoundError):
        cli_eval.main([*argv, "--checkpoint", str(tmp_path / "nothing")])
    # stage-1 pretraining is ported: it goes on to the device check
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli_train.main(["--task", "stage1"])


def test_cli_eval_takes_a_reference_torch_checkpoint(trained, tmp_path):
    """``--torch-checkpoint``: a reference BLIP-2 state dict goes through
    ``convert_blip2`` over the seeded model; the answers equal those of the
    same tree laid over the model directly."""
    opts = trained["opts"]
    cfg = cli_eval.load_config(None, opts)
    sd = fake_blip2_state_dict(cfg.blip2, 100, np.random.RandomState(9))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "r.pth")
    got = cli_eval.main(["--task", "3d_vqa", "--synthetic", "--device", "cpu",
                         "--torch-checkpoint", str(tmp_path / "r.pth"),
                         "--output", str(tmp_path / "ev"), "--options", *opts])
    b = cfg.blip2
    model = tb2.Blip2T5(b, dtype=torch.float32, device="cpu", seed=cfg.train.seed)
    tree = convert_blip2(sd, b.qformer.num_layers, b.qformer.cross_attention_freq,
                         vocab_size=b.t5.vocab_size)
    load_jax_variables(model, tree, {}, partial=True)
    val = tdata.synthetic_threedvqa(b, 1, 4, seed=1)
    want = ttrainer.evaluate_generation(cfg, model, tdata.eval_batches(val, 4), val.text.decode)
    results = json.load(open(tmp_path / "ev" / "vqa_result.json"))
    assert {r["question_id"]: r["answer"] for r in results} == want
    assert got["scores"]["All"]["count"] == 4


@pytest.fixture(scope="module")
def crossed():
    """One set of weights in both packages, and the synthetic val set."""
    jcfg, tcfg = blip2_cfgs(["eval.batch_size=3", "eval.max_gen_len=6"])
    jds = jdata.synthetic_threedvqa(jcfg.blip2, 1, 4, seed=1)
    tds = tdata.synthetic_threedvqa(tcfg.blip2, 1, 4, seed=1)
    example = blip2_batch(np.random.RandomState(0), jcfg.blip2)
    jm = jb2.Blip2T5(jcfg.blip2)
    v = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), example),
                            np.random.RandomState(4))
    tm = tb2.Blip2T5(tcfg.blip2, device="cpu")
    assert load_jax_variables(tm, to_numpy_tree(v["params"]), {}) == []
    return {"jcfg": jcfg, "tcfg": tcfg, "jds": jds, "tds": tds, "jm": jm, "v": v, "tm": tm}


def test_the_slice_matches_reference_from_data_to_scores(crossed, tmp_path):
    c = crossed
    with jax.default_matmul_precision("highest"):
        want = jtrainer.evaluate_generation(c["jcfg"], c["jm"], c["v"]["params"],
                                            jdata.eval_batches(c["jds"], 3),
                                            c["jds"].text.decode,
                                            output_dir=str(tmp_path / "j"))
    got = ttrainer.evaluate_generation(c["tcfg"], c["tm"], tdata.eval_batches(c["tds"], 3),
                                       c["tds"].text.decode, output_dir=str(tmp_path / "t"))
    assert got == want and len(got) == 4
    assert (tmp_path / "t" / "vqa_result.json").read_text() == \
        (tmp_path / "j" / "vqa_result.json").read_text()
    golds, questions = tdata.gold_answers(c["tds"])
    args = ({str(k): a for k, a in got.items()}, {str(k): g for k, g in golds.items()},
            {str(k): q for k, q in questions.items()})
    assert score_results(*args) == j_score_results(*args)


def test_dialogue_and_reading_comprehension_valid_steps_match_reference(crossed):
    c = crossed
    batch = next(jdata.train_batches(c["jds"], 3, seed=0))
    assert_batches_equal(next(tdata.train_batches(c["tds"], 3, seed=0)), batch)
    jd = jtasks.setup_task("dialogue", c["jcfg"])
    td = ttasks.setup_task("dialogue", c["tcfg"], device="cpu")
    # the reference tasks' valid_step bodies, jitted
    clean = {k: x for k, x in batch.items() if k != "question_id"}
    want = float(_jit(lambda v: c["jm"].apply(v, clean)["loss"], c["v"]))
    got = td.valid_step(c["tm"], batch)
    assert abs(got - want) <= RTOL * abs(want)
    assert td.after_evaluation([got, got]) == jd.after_evaluation([got, got])

    eb = next(jdata.eval_batches(c["jds"], 3))
    assert_batches_equal(next(tdata.eval_batches(c["tds"], 3)), eb)
    jr = jtasks.setup_task("vqa_reading_comprehension", c["jcfg"], max_len=6)
    tr = ttasks.setup_task("vqa_reading_comprehension", c["tcfg"], device="cpu", max_len=6)
    # the beam decoder itself is held against JAX in test_torch_blip2.py; here
    # the task's decoding knobs and its result records
    knobs = ("num_beams", "max_len", "min_len", "top_p", "repetition_penalty",
             "use_nucleus_sampling")
    assert [getattr(tr, k) for k in knobs] == [getattr(jr, k) for k in knobs]
    tokens = tb2.generate(c["tm"], eb, num_beams=jr.num_beams, max_length=jr.max_len,
                          min_length=jr.min_len, top_p=jr.top_p).numpy()
    want = [{"question_id": str(q), "answer": c["jds"].text.decode(list(t))}
            for q, t in zip(eb["question_id"], tokens)]
    got = tr.valid_step(c["tm"], eb, decode_fn=c["tds"].text.decode)
    assert got == want and len(got) == 3
    golds = {str(tdata.question_id_int(r, i)): r["answers"]
             for i, r in enumerate(c["tds"].records)}
    assert tr.after_evaluation(got, golds) == jr.after_evaluation(want, golds)
    cap = ttasks.setup_task("captioning", c["tcfg"], device="cpu")
    assert cap.cfg.blip2.prompt == "{}" and c["tcfg"].blip2.prompt != "{}"
    assert isinstance(ttasks.setup_task("retrieval", c["tcfg"], device="cpu"),
                      ttasks.RetrievalTask)
