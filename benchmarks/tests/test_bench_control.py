"""The control comes out not correct: the reference computed one precision
step below the configuration's bfloat16 (float8 e4m3 products, per-tensor
scales), put in the program's place, fails at least one of its cell's
limits. At a tiny size on the CPU here; at the cell's own size, three seeds,
on the card (``-m chip``)."""
import pytest

from benchmarks.harness.cell import cell_files
from benchmarks.harness.main import driver_for
from benchmarks.harness.trace import Tracer
from benchmarks.tests.conftest import tiny_files

CELLS = ["sig3d.train", "sig3d.answer.full_forward", "sig3d.answer.scene_cache",
         "blip2_flant5xl.answer"]


def control_fails(files, seed, device) -> bool:
    d = driver_for(files, seed, device)
    d.setup()
    d.window(0.5, Tracer(False))
    readings = d.readings(precision="fp8_e4m3", program=False)
    return any(v > files["limits"][k] for k, v in readings.items())


@pytest.mark.parametrize("workload", CELLS[:3])
def test_control_fails_tiny(workload):
    assert control_fails(tiny_files(workload), 2 ** 35 + 3, "cpu")


# a 3D-LLM narrow enough for the CPU and as deep as FlanT5-XL
DEEP_T5 = {"t5.d_model": 256, "t5.d_ff": 640, "t5.num_heads": 8, "t5.d_kv": 32,
           "t5.num_layers": 24, "t5.num_decoder_layers": 24, "t5.vocab_size": 65536,
           "qformer.hidden_size": 64, "qformer.intermediate_size": 128}


def test_control_departs_where_the_program_does_not():
    """At this width the control's widest gap stays near the full-size limit
    (0.19-0.34 on three seeds, against 1.06-1.40 at full width on the card);
    what holds at any size is that the float32 program serves the
    reference's best token at every position and the control does not."""
    files = tiny_files("blip2_flant5xl.answer")
    files["config"]["settings"].update(DEEP_T5)
    files["config"]["tokenizer_vocab"] = 32128
    files["traffic"].update({"batch_size": 4, "pool_batches": 2, "check_batches": 2})
    d = driver_for(files, 2 ** 35 + 3, "cpu")
    d.setup()
    d.window(0.5, Tracer(False))
    assert d.readings()["logit_gap"] == 0.0
    assert d.readings(precision="fp8_e4m3", program=False)["logit_gap"] > 0.1


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2 ** 35 + 11, 2 ** 35 + 12, 2 ** 35 + 13])
def test_control_fails_at_size(workload, seed, card):
    assert control_fails(cell_files(workload), seed, card)
