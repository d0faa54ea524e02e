"""The references compute what the program computes: at a tiny size on the
CPU, in float32 (the program's plain versions in place of its kernels), the
program and the reference agree to rounding; at full size their tensors
have the same names and shapes."""
import numpy as np
import pytest
import torch

from benchmarks.drivers import _sig3d as common
from benchmarks.harness.main import driver_for
from benchmarks.harness.trace import Tracer
from benchmarks.reference import blip2 as ref_blip2
from benchmarks.reference import sig3d as ref_sig3d
from benchmarks.harness.cell import cell_files
from benchmarks.tests.conftest import tiny_files

SEED = 2 ** 32 + 99


def _shapes(model):
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}


def test_full_size_specs_match_the_program():
    from situation3d_tpu_torch.config import Blip2Config
    from situation3d_tpu_torch.models.blip2_t5 import Blip2T5
    from situation3d_tpu_torch.models.sig3d import SIG3D
    s = cell_files("sig3d.train")["config"]["settings"]
    cfg = common.port_config(s)
    with torch.device("meta"):
        model = SIG3D(cfg, s["data.num_answers"], device="meta")
    assert _shapes(model) == ref_sig3d.param_spec(s)
    b = cell_files("blip2_flant5xl.answer")["config"]["settings"]
    bcfg = Blip2Config()
    for k, v in b.items():
        common.set_dotted(bcfg, k, v)
    model = Blip2T5(bcfg, device="meta")
    assert _shapes(model) == ref_blip2.param_spec(b)
    assert sum(int(np.prod(v)) for v in ref_blip2.param_spec(b).values()) == 3_093_333_504


def test_sig3d_forward_and_plan():
    d = driver_for(tiny_files("sig3d.answer.full_forward"), SEED, "cpu")
    d.setup()
    got = d._answer(0)
    model, _ = common.reference(d.s, SEED, "cpu")
    want = model.forward(common.to_device(d.pool[0][1], "cpu"), sample_draws=d.draws[0])
    for k in ("answer_scores", "aux_scores"):
        assert torch.allclose(got[k], want[k], rtol=0, atol=1e-5 * float(want[k].abs().max()))
    # the reference's levels are the program's, slot for slot
    from situation3d_tpu_torch.sparse.minkunet import build_unet_plan
    b = d.pool[0][1]
    plan = build_unet_plan(torch.as_tensor(b["voxel_coords"]), torch.as_tensor(b["voxel_mask"]),
                           d.s["sparse.capacities"], d.s["sparse.grid_extent"], device="cpu")
    levels = ref_sig3d.build_plan(torch.as_tensor(b["voxel_coords"]),
                                  torch.as_tensor(b["voxel_mask"]),
                                  d.s["sparse.capacities"], d.s["sparse.grid_extent"])
    for mine, theirs in zip(levels, plan["levels"]):
        assert torch.equal(mine["mask"], theirs["mask"])
        assert torch.equal(mine["coords"][mine["mask"]].int(), theirs["coords"][theirs["mask"]])
        v_in = theirs["map_k3"].shape[1]
        assert torch.equal(torch.where(mine["k3"] < 0, v_in, mine["k3"]).int(), theirs["map_k3"])


def test_sig3d_training_steps():
    d = driver_for(tiny_files("sig3d.train"), SEED, "cpu")
    d.setup()
    readings = d.readings()
    assert max(readings.values()) < 1e-5, readings


def test_scene_cache_answers():
    d = driver_for(tiny_files("sig3d.answer.scene_cache"), SEED, "cpu")
    d.setup()
    d.window(0.2, Tracer(False))
    assert max(d.readings().values()) < 1e-5


def test_blip2_logits():
    d = driver_for(tiny_files("blip2_flant5xl.answer"), SEED, "cpu")
    d.setup()
    batch = {k: torch.as_tensor(v) for k, v in d.pool[0].items()}
    tokens = d._answer(0)
    from situation3d_tpu_torch.models.t5 import shift_right
    embeds, mask = d.model.prepare(batch)
    with torch.no_grad():
        dec_in = shift_right(tokens, 0, 0)
        got = d.model.t5(embeds, mask, dec_in, torch.ones_like(tokens))
    ref = ref_blip2.Blip2Reference(d.s, ref_blip2_weights(d))
    want = ref.logits(batch, tokens)
    assert torch.allclose(got.float(), want, rtol=0, atol=1e-4 * float(want.abs().max()))
    assert ref_blip2.logit_gap(want, tokens, ref_blip2.served_positions(tokens, 1)) == 0.0


def ref_blip2_weights(d):
    from benchmarks.reference.weights import make_weights
    return make_weights(ref_blip2.param_spec(d.s), SEED, "cpu", d.config.get("init_scale"))


def test_served_positions():
    t = torch.tensor([[5, 1, 0, 0], [4, 6, 7, 8]])
    assert ref_blip2.served_positions(t, 1).tolist() == [[True, True, False, False], [True] * 4]


@pytest.mark.parametrize("precision", ["float32", "fp8_e4m3"])
def test_precisions(precision):
    from benchmarks.reference.precision import make
    p = make(precision)
    x = torch.randn(64, 32, dtype=torch.float64).float()
    err = float((p.q(x) - x).abs().max() / x.abs().max())
    assert err == 0.0 if precision == "float32" else 1e-3 < err < 0.07
