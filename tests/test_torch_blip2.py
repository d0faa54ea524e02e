"""The port's 3D-LLM (``models/{positional,qformer,blip2_t5}.py``, its
optimizer mask and ``train/blip2_trainer.py``, the checkpoint converters)
against the JAX package at a tiny width (T5 2 + 2 layers at 64, Q-Former 2
layers at 64 with 4 queries, 48-d scene features, 64 scene tokens, prompts
of 16), float32, weights carried over by ``load_jax_variables``; the JAX
side under ``jax.jit`` at full float32 matmul precision.

Tolerances: the Q-Former within 1e-5 of its largest output; loss, logits
and every trainable gradient within 1e-4 of the largest value of the
tensor, or 1e-7 where that is smaller (the gradient of a self-attention key
bias is zero in exact arithmetic and float32 noise of 1e-9 in both); greedy
and beam tokens equal; one optimizer update within 1e-5 where ``|g| >= 1e-2`` (below that Adam's ``g / (sqrt(g^2) + eps)`` amplifies
float32 noise), every update within the learning rate; converted
checkpoints equal to the JAX converters' trees bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ckpt_compat.blip2 import convert_blip2 as j_convert_blip2
from situation3d_tpu.ckpt_compat.t5 import convert_t5 as j_convert_t5
from situation3d_tpu.models import blip2_t5 as jb2
from situation3d_tpu.models import positional as jpos
from situation3d_tpu.models.qformer import QFormer as JQFormer
from situation3d_tpu.train import blip2_trainer as jtrainer
from situation3d_tpu.train import optim as joptim
from situation3d_tpu_torch.ckpt_compat import blip2 as tblip2_ckpt
from situation3d_tpu_torch.ckpt_compat import t5 as tt5_ckpt
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.models import blip2_t5 as tb2
from situation3d_tpu_torch.models import positional as tpos
from situation3d_tpu_torch.train import blip2_trainer as ttrainer
from situation3d_tpu_torch.train import optim as toptim
from torch_port_util import (blip2_batch, blip2_cfgs, fake_blip2_state_dict,
                             fake_t5_state_dict, random_variables_of, t2n, to_numpy_tree,
                             tree_get)

torch.set_num_threads(1)
QF_RTOL = 1e-5
RTOL = 1e-4
LR = 1e-2
MAX_LEN = 8


def _jit(fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _close(got, want, rtol, what="", atol=0.0):
    err, scale = np.abs(np.asarray(got) - want).max(), np.abs(want).max()
    assert err <= max(rtol * scale, atol), (what, err, scale)


def _port_model(tcfg, params):
    m = tb2.Blip2T5(tcfg.blip2, device="cpu")
    assert load_jax_variables(m, to_numpy_tree(params), {}) == []
    return m


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = blip2_cfgs([f"train.lr={LR}"])
    rng = np.random.RandomState(0)
    batch = blip2_batch(rng, jcfg.blip2)
    jm = jb2.Blip2T5(jcfg.blip2)
    v = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), batch), rng)
    params = v["params"]
    mask = joptim.blip2_trainable_mask(jcfg, params)

    def loss_fn(p):
        out = jm.apply({"params": p}, batch)
        return out["loss"], out["logits"]

    # one jit: loss, logits and gradients, and the Q-Former alone on other inputs
    enc = np.random.RandomState(2).randn(3, 64, 48).astype(np.float32)
    ((loss, logits), grads), qf_out = _jit(lambda p: (
        jax.value_and_grad(loss_fn, has_aux=True)(p),
        JQFormer(jcfg.blip2.qformer).apply({"params": p["qformer"]}, enc, batch["pc_mask"])),
        params)
    return {"jcfg": jcfg, "tcfg": tcfg, "batch": batch, "jm": jm, "params": params,
            "mask": mask, "loss": loss, "logits": logits, "grads": grads,
            "qformer_in": enc, "qformer_out": qf_out}


def test_position_encoding_matches_reference():
    np.testing.assert_array_equal(tpos.voxel_position_table(469),
                                  jpos.voxel_position_table(469))
    table = jpos.voxel_position_table(16)
    pc = np.random.RandomState(1).randint(-9, 300, (2, 7, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        t2n(tpos.voxel_position_embedding(torch.from_numpy(pc), 48, torch.from_numpy(table))),
        np.asarray(jpos.voxel_position_embedding(jnp.asarray(pc), 48, jnp.asarray(table))))


def test_qformer_matches_reference(ref):
    """Every layer kind (self-attention, cross-attention in layer 0 only at
    freq 2, the query FFN); masked scene tokens change nothing."""
    b, enc, want = ref["batch"], ref["qformer_in"].copy(), ref["qformer_out"]
    m = _port_model(ref["tcfg"], ref["params"])
    assert m.qformer.layer0.crossattention is not None and m.qformer.layer1.crossattention is None
    got = t2n(m.qformer(torch.from_numpy(enc), torch.from_numpy(b["pc_mask"])))
    _close(got, want, QF_RTOL)
    enc[b["pc_mask"] == 0] = 999.0
    np.testing.assert_array_equal(
        t2n(m.qformer(torch.from_numpy(enc), torch.from_numpy(b["pc_mask"]))), got)


def test_loss_logits_and_trainable_gradients_match_reference(ref):
    tcfg = ref["tcfg"]
    m = _port_model(tcfg, ref["params"])
    mask = toptim.blip2_trainable_mask(tcfg, m)
    for n, p in m.named_parameters():
        p.requires_grad_(mask[n])
    out = m(ref["batch"])
    out["loss"].backward()
    _close(t2n(out["loss"]), ref["loss"], RTOL, "loss")
    _close(t2n(out["logits"]), ref["logits"], RTOL, "logits")
    n_trained = 0
    for name, p in m.named_parameters():
        if not mask[name]:
            assert p.grad is None, name
            continue
        g = t2n(p.grad)
        _close(g, _jax_leaf(ref["grads"], m, name), RTOL, name, atol=1e-7)
        if not name.endswith("key.bias"):
            assert np.abs(g).max() > 1e-4, name
        n_trained += 1
    assert n_trained > 30


def _jax_leaf(tree, model, name):
    """The reference leaf of port parameter ``name``, in the port's layout."""
    from torch_port_util import flax_paths
    path, tr = flax_paths(model)[name]
    x = np.asarray(tree_get(tree, path))
    return x.T if tr else x


def test_trainable_count_matches_reference(ref):
    m = _port_model(ref["tcfg"], ref["params"])
    got = toptim.trainable_count(m, toptim.blip2_trainable_mask(ref["tcfg"], m))
    want = joptim.trainable_count(ref["params"], ref["mask"])
    assert got == want and got[0] < got[1]
    # only shared and lm_head of T5 train
    mask = toptim.blip2_trainable_mask(ref["tcfg"], m)
    assert sorted(n for n in mask if n.startswith("t5.") and mask[n]) == [
        "t5.lm_head.weight", "t5.shared.weight"]


@pytest.fixture(scope="module")
def stepped(ref, tmp_path_factory):
    jcfg, tcfg, params = ref["jcfg"], ref["tcfg"], ref["params"]
    # the reference step's update: its gradients of the trainable leaves are
    # the ones above (it stops the frozen ones), its optimizer zeroes the rest
    tx, _ = jtrainer.make_blip2_optimizer(jcfg, params, 10)
    new_params = _jit(lambda g, p: jax.tree_util.tree_map(
        jnp.add, p, tx.update(g, tx.init(p), p)[0]), ref["grads"], params)
    cfg = type(tcfg)(**{**tcfg.__dict__, "train": type(tcfg.train)(
        **{**tcfg.train.__dict__, "ckpt_dir": str(tmp_path_factory.mktemp("ckpt"))})})
    m = _port_model(cfg, params)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    trainer = ttrainer.Blip2Trainer(cfg, m, 10)
    got = ttrainer.blip2_train_step(cfg, trainer.state, ref["batch"])
    return {"model": m, "before": before, "metrics": got, "new_params": new_params,
            "trainer": trainer}


def test_one_trainer_update_matches_reference(ref, stepped):
    m, before = stepped["model"], stepped["before"]
    assert float(stepped["metrics"]["grads_finite"]) == 1.0
    _close(float(stepped["metrics"]["loss"]), ref["loss"], RTOL)
    moved = 0
    for name, p in m.named_parameters():
        want = _jax_leaf(stepped["new_params"], m, name)
        if not p.requires_grad:
            assert p.grad is None and torch.equal(p, before[name]), f"frozen {name}"
            np.testing.assert_array_equal(want, t2n(before[name]))
            continue
        got = t2n(p)
        g = np.abs(_jax_leaf(ref["grads"], m, name))
        sure = g >= 1e-2
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5, rtol=0, err_msg=name)
        bound = LR * (1 + 0.05 * np.abs(t2n(before[name]))) + 1e-6
        assert (np.abs(got - t2n(before[name])) <= bound).all(), name
        moved += int(sure.sum())
    assert moved > 1000


def test_train_step_spans_leave_the_update_bit_equal(ref):
    """``blip2_train_step`` under a recording CPU profiler opens its spans
    and gives the update it gives with none recording, bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    tcfg = ref["tcfg"]
    models = []
    for record in (False, True):
        m = _port_model(tcfg, ref["params"])
        state = ttrainer.Blip2Trainer(tcfg, m, 10).state
        if record:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                ttrainer.blip2_train_step(tcfg, state, ref["batch"])
            names = {e.name for e in prof.events()}
        else:
            ttrainer.blip2_train_step(tcfg, state, ref["batch"])
        models.append(m)
    assert {"train.step", "train.loss", "train.backward", "train.nan_guard",
            "train.optimizer"} <= names
    for (n, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(p, q), n


def test_checkpoint_roundtrip_holds_the_trainable_state(ref, stepped, tmp_path):
    """A checkpoint keeps the trainable tensors, the optimizer and the step;
    ``resume`` puts them back into a model rebuilt from the same seed, and a
    trainable-only ``.npz`` holds exactly the trainable tensors."""
    trainer = stepped["trainer"]
    trainer.save({"val_em": 0.5})
    saved = trainer.ckpt.restore()
    assert saved["step"] == 1 and sorted(saved["trainable"]) == sorted(
        n for n, p in stepped["model"].named_parameters() if p.requires_grad)
    fresh = _port_model(trainer.cfg, ref["params"])
    again = ttrainer.Blip2Trainer(trainer.cfg, fresh, 10)
    assert again.resume() and again.state.step == 1 and again.reload_best() == 1
    for (n, p), q in zip(fresh.named_parameters(), stepped["model"].parameters()):
        assert torch.equal(p, q), n
    assert again.state.optimizer.updates == 1
    n = trainer.save_trainable(str(tmp_path / "best.npz"))
    with np.load(tmp_path / "best.npz") as f:
        assert len(f.files) == n == len(saved["trainable"])


def test_predict_answers_and_generate_tokens_equal_reference(ref):
    jm, params, batch = ref["jm"], ref["params"], ref["batch"]
    m = _port_model(ref["tcfg"], params)
    greedy, beam = _jit(lambda p: (
        jb2.predict_answers(jm, {"params": p}, batch, MAX_LEN),
        jb2.generate(jm, {"params": p}, batch, num_beams=3, max_length=MAX_LEN)), params)
    np.testing.assert_array_equal(t2n(tb2.predict_answers(m, batch, MAX_LEN)), greedy)
    np.testing.assert_array_equal(t2n(tb2.generate(m, batch, num_beams=3,
                                                   max_length=MAX_LEN)), beam)


def test_converters_match_reference_and_load(ref):
    """``convert_t5`` / ``convert_blip2`` give the JAX converters' trees, bit
    for bit (vocabulary resize included); laid over the port model they fill
    every T5 and Q-Former tensor, and the model's logits equal the JAX
    model's on the same converted tree."""
    jcfg, tcfg = ref["jcfg"], ref["tcfg"]
    b = jcfg.blip2
    rng = np.random.RandomState(5)
    t5_sd = fake_t5_state_dict(b.t5, 100, rng)
    b2_sd = fake_blip2_state_dict(b, 100, rng)
    args = (b.t5.num_layers, b.t5.num_decoder_layers, b.t5.vocab_size)
    t5_tree, jt5_tree = tt5_ckpt.convert_t5(t5_sd, *args), j_convert_t5(t5_sd, *args)
    qa = (b.qformer.num_layers, b.qformer.cross_attention_freq)
    b2_tree = tblip2_ckpt.convert_blip2(b2_sd, *qa, vocab_size=b.t5.vocab_size)
    jb2_tree = j_convert_blip2(b2_sd, *qa, vocab_size=b.t5.vocab_size)
    for got, want in ((t5_tree, jt5_tree), (b2_tree, jb2_tree)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    m = tb2.Blip2T5(tcfg.blip2, device="cpu", seed=3)
    assert load_jax_variables(m.t5, t5_tree, {}, partial=True) == []
    assert load_jax_variables(m, b2_tree, {}, partial=True) == []
    np.testing.assert_array_equal(t2n(m.t5.shared.weight[:100]), b2_sd["t5_model.shared.weight"])
    full = tblip2_ckpt.merge_params({"t5": t5_tree}, b2_tree)
    want = _jit(lambda p: ref["jm"].apply({"params": p}, ref["batch"])["logits"], full)
    _close(t2n(m(ref["batch"])["logits"]), want, RTOL)


def test_loading_names_what_is_wrong(ref):
    m = tb2.Blip2T5(ref["tcfg"].blip2, device="cpu")
    params = jax.tree_util.tree_map(np.array, to_numpy_tree(ref["params"]))
    del params["qformer"]["query_tokens"]
    with pytest.raises(KeyError, match="query_tokens"):
        load_jax_variables(m, params, {})
    params = to_numpy_tree(ref["params"])
    params = {**params, "t5_proj": {"kernel": np.zeros((64, 65), np.float32),
                                    "bias": params["t5_proj"]["bias"]}}
    with pytest.raises(ValueError, match="t5_proj"):
        load_jax_variables(m, params, {})
