"""Whole training steps at world 2 (gloo, two spawned processes,
``tests/torch_ddp_worker.py``) against the port's one-process step on the
same global batch, at tiny widths in float32.

The one-process steps are held against the JAX package by
``test_torch_train_step.py``, ``test_torch_blip2.py`` and
``test_torch_blip2_stage1.py``; holding world 2 to world 1 holds it to JAX's
mesh step, whose update is the global batch's. Each rank keeps its rows of
the global batch; random draws are the global batch's rows.

Tolerances: losses within 1e-6 (relative); every updated tensor within 1e-5
of its largest value where the one-process gradient is at least 1e-2 in
magnitude, and elsewhere within the largest move Adam can make (its first
update is ``lr * g / (|g| + eps)``, which turns rounding noise on a
near-zero gradient into a full step); the ranks' parameters bit-equal after
every step.

- SIG3D, scene encoder unfrozen, dropout on, two steps: the UNet decoder,
  which gets no gradient, decays as in one process;
- a stage-1 ``Blip2Qformer`` step with the global Gumbel draws injected: its
  ITC, ITM and LM terms and its update (the ranks' captions differ in
  length);
- a ``Blip2T5`` step whose two ranks hold answers of different lengths: the
  loss is the global token mean, which the mean of the ranks' own token
  means is not;
- a non-finite loss on one rank leaves both ranks' parameters, Adam moments
  and update count unchanged;
- generation (``evaluate_generation``): each rank's result file, rank 0's
  merge, every answer on every rank, equal to one process's.
"""
import json

import numpy as np
import pytest
import torch

import torch_ddp_worker as W
from torch_port_util import BLIP2_TINY, TINY, blip2_batch

torch.set_num_threads(1)
WORLD = 2
B = 4                           # the global batch: 2 rows a rank
LR = 1e-2
LOSS_RTOL = 1e-6
RTOL = 1e-5
G_MIN = 1e-2
SIG3D = [*TINY, "train.frozen_prefixes=", f"train.lr={LR}"]
STAGE1 = [*BLIP2_TINY, "blip2.qformer.vocab_size=96", "blip2.qformer.max_position=40",
          f"train.lr={LR}"]
T5 = [*BLIP2_TINY, f"train.lr={LR}"]
DECODER = ("convtr4p16s2", "bntr4", "block5", "convtr5p8s2", "bntr5", "block6")


def _stage1_batch(rng, L=10):
    """Captions of 10, 6, 3 and 8 tokens: the ranks hold 16 and 11."""
    from situation3d_tpu_torch.config import Config, apply_overrides
    q = apply_overrides(Config(), STAGE1).blip2.qformer
    N, Wd = q.scene_token_capacity, q.encoder_width
    im = (np.arange(N)[None] < np.array([64, 40, 23, 51])[:, None]).astype(np.int32)
    tm = (np.arange(L)[None] < np.array([10, 6, 3, 8])[:, None]).astype(np.int32)
    return {"image_embeds": (rng.randn(B, N, Wd) * im[..., None]).astype(np.float32),
            "image_mask": im,
            "text_ids": (rng.randint(4, q.vocab_size - 2, (B, L)) * tm).astype(np.int32),
            "text_mask": tm}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from situation3d_tpu_torch.config import Config, apply_overrides
    from situation3d_tpu_torch.data.synthetic import make_scene_batch
    rng = np.random.RandomState(0)
    scfg = apply_overrides(Config(), SIG3D)
    sig3d_batches = [{k: v.numpy() for k, v in make_scene_batch(
        scfg, B, np.random.RandomState(s), device="cpu")[0].items()} for s in (5, 6)]
    bcfg = apply_overrides(Config(), T5).blip2
    good = blip2_batch(rng, bcfg, B=B, n_points=(64, 40, 23, 50), n_prompt=(16, 9, 5, 12),
                       n_ans=(3, 8, 1, 2))
    bad = {**good, "pc_feat": good["pc_feat"].copy()}
    bad["pc_feat"][B // 2:] = np.nan                        # rank 1's rows only
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (2, B, B))
    evals = [{**blip2_batch(rng, bcfg, B=B, n_points=(64, 40, 23, 50), n_prompt=(16, 9, 5, 12),
                            n_ans=(3, 8, 1, 2)),
              "question_id": np.arange(B, dtype=np.int32) + 10 * i,
              "sample_valid": np.arange(B) < (B if i == 0 else B - 1)} for i in range(2)]
    gen_dirs = {w: tmp_path_factory.mktemp(f"generation{w}") for w in (1, WORLD)}
    p = {"sig3d_options": SIG3D, "sig3d_batches": sig3d_batches,
         "stage1_options": STAGE1, "stage1_batch": _stage1_batch(rng),
         "gumbel": tuple((-np.log(-np.log(u))).astype(np.float32)),
         "t5_options": T5, "t5_batches": [good, bad], "eval_batches": evals,
         "eval_dir": gen_dirs[WORLD]}
    started = W.start("steps", p, tmp_path_factory.mktemp("steps"))

    # one process, the same global batches, while the ranks run
    ref = {}
    cfg, model, state = W.sig3d_setup(SIG3D)
    ref["sig3d_start"] = W.params_of(model)
    ref["sig3d"] = W.sig3d_steps(cfg, model, state, sig3d_batches)
    ref["sig3d_trainable"] = {n for n, t in model.named_parameters() if t.requires_grad}
    _, model, opt = W.stage1_setup(STAGE1)
    ref["stage1"] = W.stage1_step(model, opt, p["stage1_batch"], p["gumbel"])
    cfg, model, state = W.t5_setup(T5)
    with torch.no_grad():       # the mean of the ranks' own token means
        ref["t5_per_rank_mean"] = float(np.mean(
            [float(model({k: v[r * 2:(r + 1) * 2] for k, v in good.items()})["loss"])
             for r in range(WORLD)]))
    ref["t5"], ref["t5_grads"] = W.t5_steps(cfg, state, [good])
    ref["generation"] = W.generate(cfg, model, evals, gen_dirs[1])
    return p, ref, W.finish(started), gen_dirs


def _hold_update(got, want, grads, what):
    """``got`` (world 2) against ``want`` (one process) after a step whose
    one-process gradients are ``grads``, by the module's rule."""
    for n, w in want.items():
        err = (got[n] - w).abs().numpy()
        scale = float(w.abs().max())
        assert not np.isnan(err).any(), (what, n)
        if n not in grads:                  # off the loss's path: exact arithmetic alike
            assert err.max() <= RTOL * scale, (what, n)
            continue
        big = grads[n].abs().numpy() >= G_MIN
        assert err[big].max(initial=0.0) <= RTOL * scale, (what, n, err[big].max())
        assert err[~big].max(initial=0.0) <= 2 * LR * (1 + scale), (what, n)


def _bit_equal_ranks(a, b, what):
    for n in a:
        assert torch.equal(a[n], b[n]), (what, n)


def test_sig3d_unfrozen_steps_equal_one_process(run):
    _, ref, ranks, _ = run
    got = [r["sig3d"] for r in ranks]
    for i in range(2):
        assert got[0]["loss"][i] == got[1]["loss"][i]
        assert got[0]["loss"][i] == pytest.approx(ref["sig3d"]["loss"][i], rel=LOSS_RTOL)
        _bit_equal_ranks(got[0]["params"][i], got[1]["params"][i], f"sig3d step {i + 1}")
        grads = ref["sig3d"]["grads"][i]
        _hold_update(got[0]["params"][i], ref["sig3d"]["params"][i], grads,
                     f"sig3d step {i + 1}")
    # the averaged gradients are the one-process gradients
    for n, g in ref["sig3d"]["grads"][0].items():
        w = got[0]["grads"][0][n]
        assert (w - g).abs().max() <= RTOL * max(g.abs().max(), G_MIN), n


def test_sig3d_decoder_decays_without_a_gradient(run):
    _, ref, ranks, _ = run
    start, want = ref["sig3d_start"], ref["sig3d"]["params"][-1]
    got = ranks[0]["sig3d"]["params"][-1]
    decoder = [n for n in want if n.split(".")[0] == "scene_encoder"
               and n.split(".")[1] in DECODER and n.endswith("kernel")]
    assert decoder and all(n in ref["sig3d_trainable"] for n in decoder)
    for n in decoder:
        assert n not in ranks[0]["sig3d"]["grads"][0]          # no gradient reached it
        assert not torch.equal(got[n], start[n])                # weight decay moved it
        torch.testing.assert_close(got[n], want[n], rtol=1e-6, atol=0)


def test_stage1_step_equals_one_process(run):
    _, ref, ranks, _ = run
    got = [r["stage1"] for r in ranks]
    assert got[0]["terms"] == got[1]["terms"]
    for k in ("loss", "loss_itc", "loss_itm", "loss_lm"):
        assert got[0]["terms"][k] == pytest.approx(ref["stage1"]["terms"][k], rel=LOSS_RTOL), k
    _bit_equal_ranks(got[0]["params"], got[1]["params"], "stage1")
    _hold_update(got[0]["params"], ref["stage1"]["params"], ref["stage1"]["grads"], "stage1")
    assert set(got[0]["grads"]) == set(ref["stage1"]["grads"])


def test_blip2_t5_loss_is_the_global_token_mean(run):
    """Rank 0 holds 11 answer tokens, rank 1 holds 3."""
    _, ref, ranks, _ = run
    got = [r["t5"][0] for r in ranks]
    want = ref["t5"][0]
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    # the data tells the two apart: averaging per rank would fail the line above
    assert abs(ref["t5_per_rank_mean"] - want["loss"]) > 1e3 * LOSS_RTOL * want["loss"]
    _bit_equal_ranks(got[0]["params"], got[1]["params"], "t5")
    _hold_update(got[0]["params"], want["params"], ref["t5_grads"][0], "t5")


def test_non_finite_loss_on_one_rank_changes_no_rank(run):
    _, _, ranks, _ = run
    assert np.isfinite(ranks[0]["t5"][1]["rank_loss"])
    assert not np.isfinite(ranks[1]["t5"][1]["rank_loss"])
    for r in ranks:
        before, after = r["t5"]
        assert after["finite"] == 0.0 and before["finite"] == 1.0
        assert after["updates"] == before["updates"] == 1
        _bit_equal_ranks(after["params"], before["params"], "params after the skipped step")
        assert len(after["adam"]) == len(before["adam"]) > 0
        for (m1, v1), (m0, v0) in zip(after["adam"], before["adam"]):
            assert torch.equal(m1, m0) and torch.equal(v1, v0)


def test_generation_merges_the_ranks_answers(run):
    """Each rank decodes its rows of every batch and writes its own result
    file; after a barrier rank 0 merges them; every rank returns every
    valid answer, as one process does."""
    _, ref, ranks, dirs = run
    assert len(ref["generation"]) == 2 * B - 1
    for r in ranks:
        assert r["generation"] == ref["generation"]
    files = sorted(p.name for p in dirs[WORLD].iterdir())
    assert files == ["vqa_result.json", "vqa_result_rank0.json", "vqa_result_rank1.json"]
    merged = json.load(open(dirs[WORLD] / "vqa_result.json"))
    assert sorted(merged, key=lambda r: r["question_id"]) == sorted(
        json.load(open(dirs[1] / "vqa_result.json")), key=lambda r: r["question_id"])
    rank1 = {r["question_id"] for r in json.load(open(dirs[WORLD] / "vqa_result_rank1.json"))}
    assert rank1 == {2, 3, 12}                # its rows of each batch, the padded one left out
