"""The 3D-LLM training cell: at a tiny size on the CPU (float32, the
program's plain versions) the program's three steps agree with the
reference's, the control does not, and the FLOPs count adds up by hand."""
import copy

import pytest

from benchmarks.flops import blip2, blip2_train
from benchmarks.harness.cell import cell_files
from benchmarks.harness.main import driver_for, run_cell
from benchmarks.harness.trace import Tracer
from benchmarks.tests.conftest import TINY_BLIP2

CELL = "blip2_flant5xl.train"
SEED = 2 ** 34 + 41


def tiny_train_files() -> dict:
    f = copy.deepcopy(cell_files(CELL))
    f["config"]["settings"].update(TINY_BLIP2)
    f["config"]["tokenizer_vocab"] = 500
    f["config"]["compute_dtype"] = "float32"
    f["traffic"].update(batch_size=3, pool_batches=4, words=[3, 20])
    return f


def test_tiny_cell_is_correct():
    result = run_cell(CELL, SEED, 0.3, False, "cpu", files=tiny_train_files())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_control_fails_tiny():
    files = tiny_train_files()
    d = driver_for(files, SEED, "cpu")
    d.setup()
    d.window(0.3, Tracer(False))
    readings = d.readings(precision="fp8_e4m3", program=False)
    assert any(v > files["limits"][k] for k, v in readings.items()), readings


def test_sample_flops_by_hand():
    s = {**cell_files(CELL)["config"]["settings"]}
    n_scene, n_p, n_a = 5120, 30, 3
    n_enc = s["qformer.num_query_tokens"] + n_p
    head = n_a * 2.0 * s["t5.d_model"] * s["t5.vocab_size"]
    fwd = blip2.question_flops(s, n_scene, n_p, n_a)
    q = blip2.qformer_flops(s, n_scene)
    # the forward, then dx through everything and dW of the trained parts
    assert blip2_train.sample_flops(s, n_scene, n_p, n_a) == pytest.approx(
        fwd + (fwd - q - head) + 2 * q + 2 * head)
    assert blip2.t5_encoder_flops(s, n_enc) > 0


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2 ** 35 + 31, 2 ** 35 + 32, 2 ** 35 + 33])
def test_control_fails_at_size(seed, card):
    from benchmarks.tests.test_bench_control import control_fails
    assert control_fails(cell_files(CELL), seed, card)
