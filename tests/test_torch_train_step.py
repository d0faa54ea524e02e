"""The training slice as a whole: the port's tiny ``SIG3D`` with the
reference's weights (``load_jax_variables``) and the reference's own
token-sampling draws, in both training configurations (scene encoder frozen,
the default, and trained too).

- loss and every trainable gradient against ``jax.value_and_grad`` of the
  reference in evaluation form (dropout off on both sides: the two
  frameworks' dropout draws cannot agree). float32, loss rtol 1e-5, gradients
  atol 1e-4 on values up to a few tens: the same products summed in another
  order through 21 sparse convs, a transformer layer and the MCAN blocks.
- one optimizer step from those gradients against the reference's
  ``make_sig3d_optimizer``. Adam's first update is ``lr * g / (|g| + eps)``,
  which turns rounding noise on a near-zero gradient into a full-size move, so
  parameters are held to 1e-5 where ``|g| >= 1e-2`` and to the largest
  possible move elsewhere; frozen leaves are bit-unchanged.
- ``Trainer.fit`` on the CPU: three steps in one go equal two steps, a
  checkpoint, a restore into a fresh trainer and one more step, bit for bit.
- ``cli.train --synthetic`` runs two steps on the CPU.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from situation3d_tpu.models import sig3d as jsig
from situation3d_tpu.train import losses as jlosses
from situation3d_tpu.train import optim as joptim
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.cli import train as cli_train
from situation3d_tpu_torch.data.synthetic import synthetic_batches
from situation3d_tpu_torch.models import sig3d as tsig
from situation3d_tpu_torch.train.losses import get_loss
from situation3d_tpu_torch.train.trainer import Trainer, create_train_state

from torch_port_util import (TINY, flax_paths, jax_sample_draws, random_variables,
                             scene_batch, t2n, tiny_cfgs, to_numpy_tree, tree_get,
                             with_targets)

torch.set_num_threads(1)
B = 2
LR = 1e-2
GRAD_ATOL = 1e-4
MODES = {"frozen": ("scene_encoder",), "unfrozen": ()}


@pytest.fixture(scope="module")
def ref():
    """The reference's loss, gradients of every leaf and sampling draws."""
    jcfg, tcfg = tiny_cfgs((f"train.lr={LR}",))
    rng = np.random.RandomState(0)
    batch = with_targets(rng, scene_batch(rng, tcfg, B), 12)
    jmodel = jsig.SIG3D(jcfg, num_answers=12)
    variables = random_variables(jmodel, batch, rng)
    key = jax.random.PRNGKey(2)
    tag = jcfg.model.situation_loss_tag

    def loss_fn(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           batch, train=False, rngs={"sample": key})
        return jlosses.get_loss(out, batch, jcfg.loss, tag)[0]

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    draws = jax_sample_draws(jmodel, variables, key, B, tcfg.sparse.capacities[-1],
                             tcfg.model.num_scene_tokens)
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, variables=variables,
                loss=float(loss), grads=to_numpy_tree(grads), draws=draws)


def _port_state(ref, mode):
    tcfg = dataclasses.replace(ref["tcfg"], train=dataclasses.replace(
        ref["tcfg"].train, frozen_prefixes=MODES[mode]))
    model = tsig.SIG3D(tcfg, 12, device="cpu")
    load_jax_variables(model, to_numpy_tree(ref["variables"]["params"]),
                       to_numpy_tree(ref["variables"]["batch_stats"]))
    return tcfg, model, create_train_state(tcfg, model, steps_per_epoch=10, seed=0)


@pytest.fixture(scope="module", params=sorted(MODES))
def stepped(request, ref):
    """Port: loss + backward in evaluation form, then one optimizer update.
    Reference: one ``tx.update`` on its own gradients."""
    mode = request.param
    tcfg, model, state = _port_state(ref, mode)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    b = model._to_device(ref["batch"])
    out = model(b, sample_draws=ref["draws"], train=False)
    loss, _ = get_loss(out, b, tcfg.loss, tcfg.model.situation_loss_tag)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    assert state.optimizer.step()

    jcfg = dataclasses.replace(ref["jcfg"], train=dataclasses.replace(
        ref["jcfg"].train, frozen_prefixes=MODES[mode]))
    params = ref["variables"]["params"]
    mask = joptim.combine_masks(
        joptim.prefix_trainable(params, MODES[mode]),
        joptim.sig3d_trainable_mask(jcfg, params))
    tx, _ = joptim.make_optimizer(jcfg.train, params, 10,
                                  trainable=joptim.sig3d_trainable_mask(jcfg, params))
    jgrads = jax.tree_util.tree_map(jnp.asarray, ref["grads"])

    @jax.jit
    def jstep(p, g):
        u, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, u)

    return dict(mode=mode, model=model, before=before, loss=float(loss.detach()), grads=grads,
                mask=mask, paths=flax_paths(model),
                new_params=to_numpy_tree(jstep(params, jgrads)))


def _as_port(leaf, transposed):
    return leaf.T if transposed else leaf


def test_loss_matches_reference(ref, stepped):
    assert np.isfinite(ref["loss"]) and ref["loss"] > 1.0
    np.testing.assert_allclose(stepped["loss"], ref["loss"], rtol=1e-5)


def test_trainable_gradients_match_reference(ref, stepped):
    """Exactly the reference's trainable leaves get a gradient, and each
    agrees with ``jax.grad``."""
    paths, grads = stepped["paths"], stepped["grads"]
    want_names = {n for n, (path, _) in paths.items() if tree_get(stepped["mask"], path)}
    got_names = {n for n, p in stepped["model"].named_parameters() if p.requires_grad}
    assert got_names == want_names
    enc = {n for n in want_names if n.startswith("scene_encoder")}
    assert bool(enc) == (stepped["mode"] == "unfrozen")
    # the per-token situation heads feed no loss: no gradient on either side
    unreached = want_names - set(grads)
    assert all(n.startswith(("position_head", "rotation_head")) for n in unreached)
    worst, largest = 0.0, 0.0
    for name in sorted(want_names):
        path, tr = paths[name]
        want = _as_port(tree_get(ref["grads"], path), tr)
        if name in unreached:
            assert float(np.abs(want).max()) == 0.0, name
            continue
        got = t2n(grads[name])
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0, err_msg=name)
        worst = max(worst, float(np.abs(got - want).max()))
        largest = max(largest, float(np.abs(want).max()))
    assert largest > 1.0 and worst <= GRAD_ATOL
    if stepped["mode"] == "unfrozen":
        kernels = [n for n in enc if n.endswith(".kernel")]
        assert len(kernels) == 1 + 4 + 2 * 4 + 3      # conv0, downs, blocks, 1x1 shortcuts
        for name in kernels:
            assert float(grads[name].abs().max()) > 1e-4, name


def test_one_optimizer_step_matches_reference(ref, stepped):
    paths, before = stepped["paths"], stepped["before"]
    moved = 0
    for name, p in stepped["model"].named_parameters():
        path, tr = paths[name]
        want = _as_port(tree_get(stepped["new_params"], path), tr)
        got = t2n(p)
        if not p.requires_grad:
            assert torch.equal(p, before[name]), f"frozen leaf {name} moved"
            np.testing.assert_array_equal(want, t2n(before[name]))
            continue
        g = np.abs(_as_port(tree_get(ref["grads"], path), tr))
        sure = g >= 1e-2
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5, rtol=0, err_msg=name)
        bound = LR * (1 + 0.05 * np.abs(t2n(before[name]))) + 1e-6
        assert (np.abs(got - t2n(before[name])) <= bound).all(), name
        moved += int(sure.sum())
    assert moved > 1000


def test_frozen_encoder_runs_without_a_graph(ref):
    """With every encoder parameter frozen the scene tower is outside the
    graph (no conv backward is built); unfrozen, its tokens carry one."""
    for mode, has_graph in (("frozen", False), ("unfrozen", True)):
        _, model, _ = _port_state(ref, mode)
        tok, _, _ = model.encode_scene(model._to_device(ref["batch"]), ref["draws"])
        assert tok.requires_grad == has_graph, mode


# ---------------------------------------------------------------------------
# Trainer.fit, checkpoints, the command line

def _trainer(tmp_path, name, seed_weights, extra=()):
    _, cfg = tiny_cfgs((f"train.ckpt_dir={tmp_path / name / 'ckpt'}",
                        f"log.log_dir={tmp_path / name / 'logs'}",
                        "train.log_every_steps=1", "train.val_every_steps=2",
                        f"train.lr={LR}", "train.seed=3", *extra))
    model = tsig.SIG3D(cfg, 12, device="cpu")
    tsig.init_random_weights(model, seed_weights)
    logged = []
    trainer = Trainer(cfg, model, steps_per_epoch=10,
                      log_fn=lambda m, s: logged.append((s, m)))
    return cfg, trainer, logged


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fit_checkpoint_restore_resume(tmp_path, mode):
    extra = () if mode == "frozen" else ("train.frozen_prefixes=",)
    cfg, whole, logged = _trainer(tmp_path, "whole", 1, extra)
    batches = list(synthetic_batches(cfg, B, 3, seed=5, device="cpu"))
    start = {n: p.detach().clone() for n, p in whole.model.named_parameters()}

    def val():
        for b in synthetic_batches(cfg, B, 1, seed=9, device="cpu"):
            yield {**b, "question_id": np.arange(B) + 100}

    state = whole.fit(iter(batches), val_iter_fn=val, max_steps=3)
    assert state.step == 3 and state.optimizer.updates == 3
    steps = [s for s, m in logged if "loss" in m]
    assert steps == [1, 2, 3] and all(np.isfinite(m["loss"]) for _, m in logged if "loss" in m)
    assert any("val/answer_acc_at1" in m for _, m in logged)
    assert logged[0][1]["lr"] == pytest.approx(LR) and "time/step" in logged[0][1]
    ckpt_dir = cfg.train.ckpt_dir
    assert whole.ckpt.all_steps() == [2, 3]        # best at the validation, and the last
    rows = open(os.path.join(ckpt_dir, "best_val_pred_answers.csv")).read().split()
    assert rows[0] == "question_id,pred_answer_id" and len(rows) == 1 + B
    trainable = {n for n, p in whole.model.named_parameters() if p.requires_grad}
    for n, p in whole.model.named_parameters():
        if n not in trainable:
            assert torch.equal(p, start[n]), f"frozen leaf {n} moved"
        elif p.dim() >= 2:          # by its gradient, or by weight decay alone
            assert not torch.equal(p, start[n]), f"trainable leaf {n} did not move"
    assert any(n.startswith("scene_encoder") for n in trainable) == (mode == "unfrozen")

    _, first, _ = _trainer(tmp_path, "split", 1, extra)
    assert not first.resume()
    first.fit(iter(batches[:2]), max_steps=2)
    _, second, _ = _trainer(tmp_path, "split", 2, extra)     # other weights: all restored
    assert second.resume() and second.state.step == 2
    assert second.state.optimizer.updates == 2
    second.fit(iter(batches[2:]), max_steps=3)
    assert second.state.step == 3
    for (n, a), (_, b) in zip(whole.model.named_parameters(),
                              second.model.named_parameters()):
        assert torch.equal(a, b), n
    metrics = second.evaluate(val())
    assert metrics["num_samples"] == B and np.isfinite(metrics["loss"])
    assert 0.0 <= metrics["answer_acc_at1"] <= 1.0 and "situation_acc_1_0m" in metrics


def test_cli_train_synthetic_runs_on_the_cpu(tmp_path):
    out = tmp_path / "run"
    cli_train.main(["--task", "sqa3d", "--synthetic", "--max-steps", "2", "--device", "cpu",
                    "--output", str(out), "--options", *TINY, "train.batch_size=2",
                    "train.log_every_steps=1", f"train.ckpt_dir={tmp_path / 'ckpt'}",
                    f"log.log_dir={tmp_path / 'logs'}"])
    info = json.load(open(out / "info.json"))
    assert info["device"] == "cpu" and info["synthetic"] and info["batch_size"] == 2
    assert json.load(open(out / "config.json"))["lang"]["hidden_size"] == 32
    rows = [json.loads(x) for x in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) for r in rows)
    assert os.path.exists(tmp_path / "ckpt" / "step_2.pt")


@pytest.mark.parametrize("argv,word", [
    (["--task", "3d_vqa", "--synthetic"], "3d_vqa"),
    (["--task", "sqa3d"], "--synthetic"),
])
def test_cli_train_names_what_is_not_ported(argv, word):
    with pytest.raises(NotImplementedError, match=word):
        cli_train.main(argv)
