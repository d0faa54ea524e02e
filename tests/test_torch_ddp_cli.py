"""``cli.train`` under ``torch.distributed.run`` with two CPU ranks (gloo):
two SIG3D steps in float32 on the synthetic datasets, global batch 2 (a
row a rank), then the validation at step 2, held against the same command
in one process.

- rank 0 alone writes: ``metrics.jsonl`` holds each logged step once, the
  checkpoint directory one ``step_2.pt`` and one ``metrics.json``;
- the logged losses and validation metrics equal one process's (losses
  within 1e-6 relative, accuracies and the best-prediction CSV exactly);
- the checkpoint's parameters equal one process's within the largest move
  two Adam steps make on a near-zero gradient (``2 * 2 * lr``; the
  gradients themselves are held to 1e-5 by ``test_torch_ddp_step.py``), and
  its optimizer count and step equal.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from situation3d_tpu_torch.cli import train as cli_train
from torch_ddp_worker import free_port
from torch_port_util import TINY

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
LR = 2e-5                       # train.lr's default
LOSS_RTOL = 1e-6


def _argv(root):
    return ["--task", "sqa3d", "--synthetic", "--max-steps", "2", "--device", "cpu",
            "--output", str(root / "run"), "--options", *TINY, "train.batch_size=2",
            "data.voxel_capacity=512", "train.bf16=false", "train.log_every_steps=1",
            "train.val_every_steps=2",
            f"train.ckpt_dir={root / 'ckpt'}", f"log.log_dir={root / 'logs'}"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two = tmp_path_factory.mktemp("two")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
         "--master-port", str(free_port()), "-m", "situation3d_tpu_torch.cli.train",
         *_argv(two)], cwd=str(two), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    one = tmp_path_factory.mktemp("one")
    cli_train.main(_argv(one))                  # meanwhile, in this process
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, out[-4000:]
    return one, two


def _rows(root):
    return [json.loads(x) for x in open(root / "logs" / "metrics.jsonl")]


def test_rank0_writes_each_file_once(runs):
    one, two = runs
    assert [r["step"] for r in _rows(two)] == [r["step"] for r in _rows(one)] == [1, 2, 2]
    assert sorted(os.listdir(two / "ckpt")) == sorted(os.listdir(one / "ckpt")) == [
        "best_val_pred_answers.csv", "metrics.json", "step_2.pt"]
    assert json.load(open(two / "ckpt" / "metrics.json")) == \
        json.load(open(one / "ckpt" / "metrics.json"))
    for name in ("info.json", "answer_vocab.json"):
        assert open(two / "run" / name).read() == open(one / "run" / name).read(), name
    assert json.load(open(two / "run" / "config.json"))["mesh"]["data_parallel"] == -1


def test_logged_metrics_equal_one_process(runs):
    one, two = runs
    for a, b in zip(_rows(two), _rows(one)):
        assert set(a) == set(b)
        for k, v in b.items():
            if k.startswith("time/"):
                continue
            if k.endswith("loss") or k.endswith("_loss") or k == "lr":
                assert a[k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-12), k
            elif "acc" in k or k in ("step", "grads_finite") or k.startswith("overflow/") \
                    or k.endswith("num_samples"):
                assert a[k] == v, k
    assert open(two / "ckpt" / "best_val_pred_answers.csv").read() == \
        open(one / "ckpt" / "best_val_pred_answers.csv").read()


def test_checkpoint_equals_one_process(runs):
    """The parameters within the largest move of two Adam steps; the Adam
    moments, which follow the averaged gradients, within 1e-5 of the
    largest moment of any tensor (gradients are sums of many terms that
    cancel in some tensors: their rounding is the whole batch's)."""
    one, two = runs
    a, b = (torch.load(r / "ckpt" / "step_2.pt", weights_only=False) for r in (two, one))
    assert a["step"] == b["step"] == 2
    assert a["optimizer"]["scheduler"]["last_epoch"] == b["optimizer"]["scheduler"][
        "last_epoch"] == 2
    assert a["model"].keys() == b["model"].keys()
    for k, v in b["model"].items():
        if v.is_floating_point():
            assert (a["model"][k] - v).abs().max() <= 2 * 2 * LR, k
        else:
            assert torch.equal(a["model"][k], v), k
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert sa.keys() == sb.keys() and len(sb) > 0
    for m in ("exp_avg", "exp_avg_sq"):
        scale = max(float(sb[i][m].abs().max()) for i in sb)
        for i in sb:
            assert (sa[i][m] - sb[i][m]).abs().max() <= 1e-5 * scale, (i, m)
