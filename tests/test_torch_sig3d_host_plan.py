"""The port's SIG3D on a batch of SQA3D-layout files that carries a host-built
plan, against the reference's SIG3D fed the reference's host plan (the two
plans are equal bit for bit, ``test_torch_host_plan.py``), with
``sparse.final_result`` on so the whole UNet runs: the reference's weights
(``load_jax_variables``, every leaf used) and its token-sampling draws,
one jitted reference call at full float32 matmul precision.

float32, atol 1e-4: ``answer_scores``, the loss and ``openscene_out``
(the same products summed in another order through 41 sparse convs, a
transformer layer and the MCAN blocks). The segmentation classes
(``argmax(openscene_out @ text_features.T)``) are equal except where the top
two logits lie within 1e-5, rows left out and counted.

Also the two repairs of this path: a plan on the batch is used (the device
plan function is replaced by one that raises) and its overflow counters are
reported; ``openscene_out`` comes out under ``final_result`` only.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from situation3d_tpu.models import sig3d as jsig
from situation3d_tpu.sparse import host_plan as jhost
from situation3d_tpu.train import losses as jlosses
from situation3d_tpu_torch.data.sqa3d import SQA3DDataset, batch_iterator
from situation3d_tpu_torch.data.vocab import build_answer_vocab, load_answer_counter
from situation3d_tpu_torch.models import sig3d as tsig
from situation3d_tpu_torch.sparse import host_plan as thost
from situation3d_tpu_torch.train.losses import get_loss

from torch_port_util import (jax_sample_draws, load_into_port,
                             random_variables, t2n, tiny_cfgs, write_small_sqa3d)

torch.set_num_threads(1)
ATOL = 1e-4
B = 2
MODEL_KEYS = ("s_ids", "s_mask", "q_ids", "q_mask", "voxel_coords", "voxel_feats",
              "voxel_mask", "auxiliary_task", "answer_cat_scores", "question_type")


def _first_batch(cfg):
    counter = load_answer_counter(cfg.data.answer_counter)
    vocab = build_answer_vocab(counter, cfg.data.answer_min_freq, cfg.data.num_answers)
    ds = SQA3DDataset(cfg, "train", vocab, counter)
    batch = next(batch_iterator(ds, B, shuffle=False))
    return {k: batch[k] for k in MODEL_KEYS}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    files = write_small_sqa3d(tmp_path_factory.mktemp("sqa3d"))
    jcfg, tcfg = tiny_cfgs(("data.voxel_capacity=512", "sparse.final_result=true", *files))
    # the two packages' batches are equal bit for bit (test_torch_sqa3d_data.py)
    tbatch = _first_batch(tcfg)
    jbatch = dict(tbatch)
    caps = tcfg.sparse.capacities
    jbatch["plan"] = jhost.build_host_plan(jbatch["voxel_coords"], jbatch["voxel_mask"], caps)
    tbatch["plan"] = thost.build_host_plan(tbatch["voxel_coords"], tbatch["voxel_mask"], caps)
    jmodel = jsig.SIG3D(jcfg, num_answers=12)
    rng = np.random.RandomState(0)
    variables = random_variables(jmodel, jbatch, rng)
    key = jax.random.PRNGKey(3)
    tag = jcfg.model.situation_loss_tag

    def run(v, b, k):
        out = jmodel.apply(v, b, train=False, rngs={"sample": k})
        return {"answer_scores": out["answer_scores"], "openscene_out": out["openscene_out"],
                "loss": jlosses.get_loss(out, b, jcfg.loss, tag)[0],
                "voxels_dropped": out["overflow/voxels_dropped"]}

    with jax.default_matmul_precision("highest"):
        jout = {k: np.asarray(v) for k, v in jax.jit(run)(variables, jbatch, key).items()}
    draws = jax_sample_draws(jmodel, variables, key, B, caps[-1], tcfg.model.num_scene_tokens)
    tmodel = load_into_port(tsig.SIG3D(tcfg, 12, device="cpu"), variables)
    with torch.no_grad():
        tout = tmodel(tbatch, sample_draws=draws)
        b = tmodel._to_device(tbatch)
        tloss = float(get_loss(tout, b, tcfg.loss, tag)[0])
    return dict(tcfg=tcfg, batch=tbatch, draws=draws, variables=variables, jout=jout,
                tmodel=tmodel, tout=tout, tloss=tloss)


def test_answer_scores_with_a_host_plan_match_the_reference(ref):
    got, want = t2n(ref["tout"]["answer_scores"]), ref["jout"]["answer_scores"]
    assert got.shape == want.shape == (B, 12) and float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_loss_with_a_host_plan_matches_the_reference(ref):
    want = float(ref["jout"]["loss"])
    assert np.isfinite(want) and abs(ref["tloss"] - want) <= ATOL * max(1.0, abs(want))


def test_openscene_out_and_its_classes_match_the_reference(ref):
    got, want = t2n(ref["tout"]["openscene_out"]), ref["jout"]["openscene_out"]
    V0, C = ref["tcfg"].sparse.capacities[0], ref["tcfg"].sparse.out_channels
    assert got.shape == want.shape == (B, V0, C) and float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    r = np.random.RandomState(0).randn(20, C)
    tf = r / np.linalg.norm(r, axis=1, keepdims=True)
    mask = ref["batch"]["voxel_mask"]
    lg, lw = got[mask] @ tf.T, want[mask] @ tf.T
    top2 = np.sort(lw, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] >= 1e-5
    assert clear.sum() >= 0.99 * len(clear), f"{(~clear).sum()} near-tied rows"
    np.testing.assert_array_equal(lg[clear].argmax(1), lw[clear].argmax(1))


def test_a_plan_on_the_batch_is_used(ref, monkeypatch):
    """No plan is built when the batch carries one: the plan function is replaced
    by one that raises, and the forward gives the same answers; the overflow
    counters are the plan's."""
    def no_plan(*args, **kwargs):
        raise RuntimeError("build_unet_plan called")

    monkeypatch.setattr(tsig, "build_unet_plan", no_plan)
    with torch.no_grad():
        out = ref["tmodel"](ref["batch"], sample_draws=ref["draws"])
        for k in ("answer_scores", "openscene_out"):
            torch.testing.assert_close(out[k], ref["tout"][k], atol=0, rtol=0)
        toks, _, overflow = ref["tmodel"].encode_scene(ref["batch"], ref["draws"])
        torch.testing.assert_close(toks, ref["tout"]["att_feat_pre"], atol=0, rtol=0)
        with pytest.raises(RuntimeError, match="build_unet_plan called"):
            ref["tmodel"]({k: v for k, v in ref["batch"].items() if k != "plan"},
                          sample_draws=ref["draws"])
    dropped = int(ref["batch"]["plan"]["overflow"]["voxels_dropped"].sum())
    assert dropped > 0 and int(out["overflow/voxels_dropped"]) == dropped
    assert int(ref["jout"]["voxels_dropped"]) == dropped
    assert int(overflow["voxels_dropped"].sum()) == dropped


def test_openscene_out_only_under_final_result(ref):
    """Without ``final_result`` the encoder runs alone and the same weights
    give the same answers (the decoder is off the answer's path)."""
    cfg = ref["tcfg"]
    plain_cfg = dataclasses.replace(
        cfg, sparse=dataclasses.replace(cfg.sparse, final_result=False))
    model = tsig.SIG3D(plain_cfg, 12, device="cpu")
    unused = model.load_state_dict(ref["tmodel"].state_dict(), strict=False)
    assert unused.missing_keys == [] and unused.unexpected_keys and all(
        k.split(".")[1] in ("convtr6p4s2", "bntr6", "block7", "convtr7p2s2", "bntr7",
                            "block8", "final") for k in unused.unexpected_keys)
    with torch.no_grad():
        out = model(ref["batch"], sample_draws=ref["draws"])
    assert "openscene_out" not in out and "openscene_out" in ref["tout"]
    torch.testing.assert_close(out["answer_scores"], ref["tout"]["answer_scores"],
                               atol=0, rtol=0)
