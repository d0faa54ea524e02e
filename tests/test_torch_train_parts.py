"""The parts of the port's trainer against the reference: loss terms,
metrics, learning-rate schedules, trainable / decay masks, AdamW updates, the
NaN guard, dropout, checkpoints and logging. Tolerances: losses and metrics
1e-5 (float32, a handful of terms), schedules 1e-6 relative (optax computes
them in float32), ten AdamW updates 1e-6 absolute."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from situation3d_tpu.models.sig3d import SIG3D as JSIG3D
from situation3d_tpu.train import losses as jlosses
from situation3d_tpu.train import metrics as jmetrics
from situation3d_tpu.train import optim as joptim
from situation3d_tpu_torch.models.layers import dropout
from situation3d_tpu_torch.models.sig3d import SIG3D, init_random_weights
from situation3d_tpu_torch.train import checkpoint as tckpt
from situation3d_tpu_torch.train import logging as tlog
from situation3d_tpu_torch.train import losses as tlosses
from situation3d_tpu_torch.train import metrics as tmetrics
from situation3d_tpu_torch.train import optim as toptim
from situation3d_tpu_torch.train.trainer import create_train_state, train_step

from torch_port_util import (flax_paths, random_variables, scene_batch, t2n,
                             tiny_cfgs, tree_get, with_targets)

torch.set_num_threads(1)
TAGS = ["__l2__quat__", "__l1__angle__", "__class__angle__", "__class____l2__6d__"]


def _loss_case(tag, seed, B=3, N=8, A=12):
    r = np.random.RandomState(seed)
    rot = {"quat": 4, "angle": 2, "6d": 6}[tag.strip("_").split("__")[-1]]
    out = {"answer_scores": r.randn(B, A).astype(np.float32) * 2}
    if "__class__" in tag:
        out["aux_scores"] = r.randn(B, N, 1 + rot).astype(np.float32)
        w = r.rand(B, N).astype(np.float32)
        out["auxiliary_task_loc_gt"] = w / w.sum(1, keepdims=True)
    else:
        out["aux_scores"] = r.randn(B, 3 + rot).astype(np.float32)
    batch = with_targets(r, {"s_ids": np.zeros((B, 1)),
                             "auxiliary_task": r.randn(B, 3 + rot).astype(np.float32)}, A)
    return out, batch


@pytest.mark.parametrize("answer_loss", ["bce", "ce"])
@pytest.mark.parametrize("tag", TAGS)
def test_get_loss_terms_match_reference(tag, answer_loss):
    jcfg, tcfg = tiny_cfgs((f"loss.answer_loss={answer_loss}", "loss.pos_weight=0.7",
                            "loss.rot_weight=1.3", "loss.aux_situation_weight=0.5"))
    out, batch = _loss_case(tag, seed=len(tag))
    want_total, want = jlosses.get_loss(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg.loss, tag)
    got_total, got = tlosses.get_loss(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, tcfg.loss, tag)
    assert set(got) == set(want) and float(want["aux_loss"]) > 0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)


def test_get_loss_switches_and_missing_targets():
    _, tcfg = tiny_cfgs()
    out, batch = _loss_case("__l2__quat__", 0)
    o = {k: torch.from_numpy(v) for k, v in out.items()}
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    total, terms = tlosses.get_loss(o, b, tcfg.loss, "__l2__quat__",
                                    use_aux_situation=False)
    assert float(terms["aux_loss"]) == 0.0
    assert float(total) == pytest.approx(10.0 * float(terms["answer_loss"]))
    _, terms = tlosses.get_loss(o, b, tcfg.loss, "__l2__quat__", use_answer=False)
    assert float(terms["answer_loss"]) == 0.0
    ce = dataclasses.replace(tcfg.loss, answer_loss="ce")
    with pytest.raises(ValueError, match="answer_cat"):
        tlosses.get_loss(o, {k: v for k, v in b.items() if k != "answer_cat"}, ce,
                         "__l2__quat__")


@pytest.mark.parametrize("with_valid", [False, True])
def test_answer_metrics_match_reference(with_valid):
    r = np.random.RandomState(1)
    B, A = 16, 30
    scores = r.randn(B, A).astype(np.float32)
    cats = (r.rand(B, A) < 0.1).astype(np.float32)
    qt = r.randint(0, 9, B).astype(np.int32)
    valid = (r.rand(B) < 0.7) if with_valid else None
    want = jmetrics.answer_metrics(jnp.asarray(scores), jnp.asarray(cats), jnp.asarray(qt),
                                   None if valid is None else jnp.asarray(valid))
    got = tmetrics.answer_metrics(torch.from_numpy(scores), torch.from_numpy(cats),
                                  torch.from_numpy(qt),
                                  None if valid is None else torch.from_numpy(valid))
    assert set(got) == set(want) and len(got) == 2 + len(tmetrics.QUESTION_TYPES)
    for k in want:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), atol=1e-6)
    assert "answer_acc_breakdown_what" not in tmetrics.answer_metrics(
        torch.from_numpy(scores), torch.from_numpy(cats))


@pytest.mark.parametrize("tag", TAGS)
def test_situation_metrics_match_reference(tag):
    out, batch = _loss_case(tag, seed=7, B=6)
    out["scene_positions"] = np.random.RandomState(2).rand(6, 8, 2).astype(np.float32) * 4
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    want = jmetrics.situation_metrics(out, batch, tag, valid)
    got = tmetrics.situation_metrics(out, batch, tag, valid)
    assert got == want and set(got) == {
        "situation_acc_0_5m", "situation_acc_1_0m", "situation_acc_15deg",
        "situation_acc_30deg"}


@pytest.mark.parametrize("name", ["step", "multistep", "warmup_cosine", "warmup_step"])
def test_schedules_match_reference(name):
    opts = (f"train.lr_schedule={name}", "train.lr=3e-4", "train.epochs=6",
            "train.lr_decay_steps=2,3,5", "train.lr_decay_rate=0.3",
            "train.warmup_steps=7", "train.min_lr=2e-5")
    jcfg, tcfg = tiny_cfgs(opts)
    spe = 5
    want = joptim.registry.get("lr_schedule", name)(jcfg.train, spe)
    got = toptim.LR_SCHEDULES[name](tcfg.train, spe)
    for step in list(range(0, 40)) + [100, 1000]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} at step {step}")


def test_bn_momentum_schedule_matches_reference():
    jcfg, tcfg = tiny_cfgs()
    for epoch in (0, 1, 19, 20, 45, 400):
        assert toptim.bn_momentum_schedule(tcfg.train, epoch) == pytest.approx(
            joptim.bn_momentum_schedule(jcfg.train, epoch))


# ---------------------------------------------------------------------------
# masks and AdamW against the reference's optimizer on the tiny SIG3D's tree

@pytest.fixture(scope="module")
def tree():
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.RandomState(3)
    batch = scene_batch(rng, tcfg, 1)
    params = random_variables(JSIG3D(jcfg, num_answers=12), batch, rng)["params"]
    model = SIG3D(tcfg, 12, device="cpu")
    return params, model, flax_paths(model)


@pytest.mark.parametrize("opts", [(), ("train.frozen_prefixes=",),
                                  ("model.lang_freeze=all",),
                                  ("model.lang_freeze=none", "train.frozen_prefixes=")])
def test_trainable_and_decay_masks_name_the_same_leaves(tree, opts):
    params, model, paths = tree
    jcfg, tcfg = tiny_cfgs(opts)
    want = joptim.combine_masks(
        joptim.prefix_trainable(params, tuple(jcfg.train.frozen_prefixes)),
        joptim.sig3d_trainable_mask(jcfg, params))
    got = toptim.combine_masks(
        toptim.prefix_trainable(model, tcfg.train.frozen_prefixes),
        toptim.sig3d_trainable_mask(tcfg, model))
    decay_want = joptim._decay_mask(params)
    decay_got = toptim.decay_mask(model.named_parameters())
    assert set(got) == set(paths) == {n for n, _ in model.named_parameters()}
    for name, (path, _) in paths.items():
        assert got[name] == tree_get(want, path), name
        assert decay_got[name] == tree_get(decay_want, path), name
    n_train, n_total = toptim.trainable_count(model, got)
    assert 0 < n_train <= n_total == sum(p.numel() for p in model.parameters())
    if not opts:
        assert not any(v for n, v in got.items() if n.startswith("scene_encoder"))
        assert got["lang_net.encoder.layer0.output.weight"]
        assert not got["lang_net.encoder.word_embeddings.weight"]
    with pytest.raises(ValueError):
        toptim.lang_freeze_trainable(model, "some", 1)


@pytest.mark.parametrize("accum", [1, 2])
def test_ten_adamw_updates_match_reference(tree, accum):
    """Same parameters, same gradients (beyond the clip value, so clipping is
    live), a schedule that moves every step: after ten updates every leaf
    agrees with optax within 1e-6; frozen leaves carry no state and do not
    move. The leaves are scaled into (-1, 1): 1e-6 is a handful of float32
    roundings there, and the two libraries round a decayed parameter once
    (optax) or twice (torch) a step."""
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.4, tree[0])
    opts = ("train.lr=1e-2", "train.lr_schedule=warmup_cosine", "train.warmup_steps=3",
            "train.epochs=4", "train.weight_decay=0.05", "train.grad_clip_value=0.5",
            f"train.grad_accum_steps={accum}")
    jcfg, tcfg = tiny_cfgs(opts)
    model = SIG3D(tcfg, 12, device="cpu")
    paths = flax_paths(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            path, tr = paths[name]
            v = np.asarray(tree_get(params, path))
            p.copy_(torch.from_numpy(np.ascontiguousarray(v.T if tr else v)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx, _ = joptim.make_optimizer(jcfg.train, jparams, 3,
                                  trainable=joptim.sig3d_trainable_mask(jcfg, jparams))
    opt, _ = toptim.make_optimizer(tcfg.train, model, 3,
                                   trainable=toptim.sig3d_trainable_mask(tcfg, model))
    opt_state = tx.init(jparams)

    @jax.jit
    def jstep(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    r = np.random.RandomState(4)
    applied = 0
    for _ in range(10 * accum):
        grads = jax.tree_util.tree_map(
            lambda x: (r.randn(*x.shape) * 0.6).astype(np.float32), params)
        jparams, opt_state = jstep(jparams, opt_state,
                                   jax.tree_util.tree_map(jnp.asarray, grads))
        for name, p in model.named_parameters():
            path, tr = paths[name]
            g = tree_get(grads, path)
            p.grad = torch.from_numpy(np.ascontiguousarray(g.T if tr else g))
        applied += bool(opt.step())
    assert applied == 10 == opt.updates
    worst = 0.0
    for name, p in model.named_parameters():
        path, tr = paths[name]
        want = np.asarray(tree_get(jparams, path))
        worst = max(worst, float(np.abs(t2n(p) - (want.T if tr else want)).max()))
        if not p.requires_grad:
            np.testing.assert_array_equal(want, np.asarray(tree_get(params, path)))
            assert p not in opt.adamw.state
    assert worst <= 1e-6, worst
    moved = float(np.abs(np.asarray(jparams["answer_cls_fc1"]["kernel"])
                         - np.asarray(params["answer_cls_fc1"]["kernel"])).max())
    assert moved > 1e-2


def test_make_optimizer_rejects_an_unknown_schedule(tree):
    _, tcfg = tiny_cfgs(("train.lr_schedule=linear",))
    with pytest.raises(KeyError, match="linear"):
        toptim.make_optimizer(tcfg.train, tree[1])


# ---------------------------------------------------------------------------
# NaN guard, dropout

@pytest.mark.parametrize("mode", ["loss", "full"])
def test_nan_guard_leaves_parameters_and_optimizer_state_untouched(mode):
    _, cfg = tiny_cfgs((f"train.nan_guard={mode}", "train.lr=1e-3"))
    rng = np.random.RandomState(5)
    model = SIG3D(cfg, 12, device="cpu")
    init_random_weights(model, 0)
    state = create_train_state(cfg, model, 10, seed=0)
    batch = with_targets(rng, scene_batch(rng, cfg, 2), 12)
    m = train_step(cfg, state, batch)
    assert float(m["grads_finite"]) == 1.0 and np.isfinite(float(m["loss"]))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = {k: {kk: vv.clone() if torch.is_tensor(vv) else vv for kk, vv in v.items()}
           for k, v in state.optimizer.adamw.state_dict()["state"].items()}
    bad = {**batch, "auxiliary_task": batch["auxiliary_task"] * np.nan}
    m = train_step(cfg, state, bad)
    assert float(m["grads_finite"]) == 0.0 and not np.isfinite(float(m["loss"]))
    assert state.step == 2 and state.optimizer.updates == 1
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n
    after = state.optimizer.adamw.state_dict()["state"]
    assert set(after) == set(opt)
    for k, v in after.items():
        for kk, vv in v.items():
            assert torch.equal(vv, opt[k][kk]) if torch.is_tensor(vv) else vv == opt[k][kk]
    m = train_step(cfg, state, batch)                      # and training goes on
    assert float(m["grads_finite"]) == 1.0 and state.optimizer.updates == 2


def test_dropout_rate_scaling_and_reproducibility():
    x = torch.ones(200, 500)
    a = dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    b = dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    c = dropout(x, 0.3, True, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(a[kept], torch.tensor(1 / 0.7))
    assert abs(float(a.mean()) - 1.0) < 0.02
    assert dropout(x, 0.3, False) is x and dropout(x, 0.0, True) is x
    assert float(dropout(x, 1.0, True).abs().max()) == 0.0


def test_model_dropout_only_in_training_form_and_encoder_stays_in_eval():
    _, cfg = tiny_cfgs()
    rng = np.random.RandomState(6)
    model = SIG3D(cfg, 12, device="cpu")
    init_random_weights(model, 0)
    batch = scene_batch(rng, cfg, 2)
    draws = torch.rand(2, 32), torch.randint(0, 100, (2, 8), dtype=torch.int32)
    model.train()
    assert model.training and not model.scene_encoder.training
    assert not any(m.training for m in model.scene_encoder.modules())
    with torch.no_grad():
        ev = model(batch, sample_draws=draws)["answer_scores"]
        ev2 = model(batch, sample_draws=draws, train=False,
                    generator=torch.Generator().manual_seed(0))["answer_scores"]
        t1 = model(batch, sample_draws=draws, train=True,
                   generator=torch.Generator().manual_seed(1))["answer_scores"]
        t2 = model(batch, sample_draws=draws, train=True,
                   generator=torch.Generator().manual_seed(1))["answer_scores"]
        t3 = model(batch, sample_draws=draws, train=True,
                   dropout_generator=torch.Generator().manual_seed(2))["answer_scores"]
    assert torch.equal(ev, ev2) and torch.equal(t1, t2)
    assert not torch.equal(ev, t1) and not torch.equal(t1, t3)


# ---------------------------------------------------------------------------
# checkpoints and logging

def test_checkpoint_manager_keep_latest_best(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), keep=2, best_metric="acc")
    assert mgr.latest_step() is None and mgr.restore() is None
    for step, acc in ((1, 0.2), (2, 0.9), (3, 0.5), (4, 0.4)):
        mgr.save(step, {"w": torch.full((2,), float(step)), "step": step}, {"acc": acc})
    mgr.save(5, {"w": torch.full((2,), 5.0), "step": 5})
    assert mgr.latest_step() == 5 and mgr.best_step() == 2
    assert mgr.all_steps() == [2, 4, 5]            # newest two + the protected best
    assert mgr.metrics(2) == {"acc": 0.9} and mgr.metrics(5) is None
    assert mgr.restore()["step"] == 5
    assert torch.equal(mgr.restore(2)["w"], torch.full((2,), 2.0))
    again = tckpt.CheckpointManager(str(tmp_path / "ck"), keep=2, best_metric="acc")
    assert again.latest_step() == 5 and again.best_step() == 2
    low = tckpt.CheckpointManager(str(tmp_path / "lo"), keep=5, best_metric="loss",
                                  best_mode="min")
    for step, loss in ((1, 3.0), (2, 1.0), (3, 2.0)):
        low.save(step, {"step": step}, {"loss": loss})
    assert low.best_step() == 2 and low.all_steps() == [1, 2, 3]


def test_trainable_npz_round_trip(tmp_path):
    _, cfg = tiny_cfgs()
    a = SIG3D(cfg, 12, device="cpu")
    init_random_weights(a, 1)
    mask = toptim.combine_masks(toptim.prefix_trainable(a, ("scene_encoder",)),
                                toptim.sig3d_trainable_mask(cfg, a))
    path = str(tmp_path / "sub" / "trainable.npz")
    n = tckpt.save_trainable_npz(path, a, mask)
    assert n == sum(mask.values())
    with np.load(path) as f:      # the reference's tree paths and [in, out] kernels
        np.testing.assert_array_equal(f["answer_cls_fc2/kernel"],
                                      a.answer_cls_fc2.weight.detach().numpy().T)
    b = SIG3D(cfg, 12, device="cpu")
    init_random_weights(b, 2)
    frozen_before = b.scene_encoder.conv0p1s1.kernel.detach().clone()
    assert tckpt.load_trainable_npz(path, b) == n
    assert torch.equal(b.answer_cls_fc2.weight, a.answer_cls_fc2.weight)
    assert torch.equal(b.scene_encoder.conv0p1s1.kernel, frozen_before)
    np.savez(str(tmp_path / "bad.npz"), **{"no/such/leaf": np.zeros(2)})
    with pytest.raises(KeyError):
        tckpt.load_trainable_npz(str(tmp_path / "bad.npz"), b)
    np.savez(str(tmp_path / "shape.npz"), **{"answer_cls_fc2/bias": np.zeros(3)})
    with pytest.raises(ValueError):
        tckpt.load_trainable_npz(str(tmp_path / "shape.npz"), b)


def test_metric_writer_smoothed_value_and_logger(tmp_path, caplog):
    w = tlog.MetricWriter(str(tmp_path / "logs"))
    w.write({"loss": 1.5, "n": 3, "skip": "text"}, 7, prefix="train/")
    w.close()
    rows = [json.loads(x) for x in open(tmp_path / "logs" / "metrics.jsonl")]
    assert rows == [{"step": 7, "train/loss": 1.5, "train/n": 3.0}]
    sv = tlog.SmoothedValue(window_size=3)
    for v in (1, 2, 3, 10):
        sv.update(v)
    assert (sv.median, sv.avg, sv.max, sv.value) == (3.0, 5.0, 10.0, 10.0)
    assert sv.global_avg == 4.0 and str(sv) == "3.0000 (4.0000)"
    ml = tlog.MetricLogger()
    ml.update(loss=2.0)
    ml.update(loss=4.0)
    assert ml.loss.global_avg == 3.0 and ml.global_avg() == {"loss": 3.0}
    with pytest.raises(AttributeError):
        ml.nope
    with caplog.at_level("INFO", logger="situation3d_tpu_torch.metrics"):
        assert list(ml.log_every([10, 20, 30], 2, header="it")) == [10, 20, 30]
    assert sum("it [" in r.message for r in caplog.records) == 2
    assert any("Total time" in r.message for r in caplog.records)


def test_step_profiler_writes_a_trace_for_its_window(tmp_path):
    off = tlog.StepProfiler(str(tmp_path / "off"), (0, 0))
    for s in range(3):
        off.maybe_toggle(s)
    assert not os.path.exists(tmp_path / "off")
    prof = tlog.StepProfiler(str(tmp_path / "on"), (1, 3))
    for s in range(5):
        prof.maybe_toggle(s)
        torch.ones(8).sum()
    files = os.listdir(tmp_path / "on")
    assert files == ["trace_steps_1_3.json"] and prof._prof is None
    assert "traceEvents" in json.load(open(tmp_path / "on" / files[0]))
