"""The GloVe + LSTM language encoder of the port (``models/lang.py``:
``OptimizedLSTMCell``, ``LSTMLangEncoder``, ``GloveLSTMEncoder``,
``LangModule(model="lstm")``) against the reference's flax modules with the
same random embedding table and LSTM leaves (loaded by the ``Dense`` rule of
``ckpt_compat/from_jax.py``), and a tiny SIG3D with
``model.lang_model=lstm``: float32, encoder outputs, the encoder's
gradients (relative to the largest where it is above 1) and answer scores
within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.models import sig3d as jsig
from situation3d_tpu.models.lang import GloveLSTMEncoder as JGloveLSTMEncoder
from situation3d_tpu.models.lang import LangModule as JLangModule
from situation3d_tpu_torch.models import sig3d as tsig
from situation3d_tpu_torch.models.lang import GloveLSTMEncoder, LangModule
from situation3d_tpu_torch.train.optim import sig3d_trainable_mask, trainable_count

from torch_port_util import (flax_paths, load_into_port, random_variables,
                             random_variables_of, scene_batch, t2n, tiny_cfgs, tree_get)

torch.set_num_threads(1)
ATOL = 1e-5
LSTM = ["model.lang_model=lstm", "lang.glove_dim=12"]


def _ids(rng, cfg, B, L, lengths):
    ids = rng.randint(0, cfg.vocab_size, (B, L)).astype(np.int32)
    mask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids, mask


def test_glove_lstm_encoder_matches_reference():
    """Rows of several lengths, one of them empty and one with a hole in its
    mask: every position the mask keeps, and zeros elsewhere."""
    jcfg, tcfg = tiny_cfgs(LSTM)
    rng = np.random.RandomState(0)
    ids, mask = _ids(rng, tcfg.lang, 4, 9, [9, 4, 1, 0])
    mask[0, 3] = 0
    jm = JGloveLSTMEncoder(jcfg.lang)
    v = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                            jnp.asarray(mask)), rng)
    leaves = jax.tree_util.tree_map(np.shape, v["params"])
    assert set(leaves["lstm_encoder"]["OptimizedLSTMCell_0"]) == {
        "ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}
    assert leaves["lstm_encoder"]["OptimizedLSTMCell_0"]["ii"] == {"kernel": (12, 32)}
    assert leaves["lstm_encoder"]["OptimizedLSTMCell_0"]["hf"] == {"bias": (32,),
                                                                   "kernel": (32, 32)}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(ids), jnp.asarray(mask)))
    tm = load_into_port(GloveLSTMEncoder(tcfg.lang), v)
    with torch.no_grad():
        got = t2n(tm(torch.from_numpy(ids), torch.from_numpy(mask)))
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert not got[3].any() and not got[0, 3].any()
    # the parameters are the reference's leaves, no more
    n_ref = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(leaves, is_leaf=lambda x:
                                                                   isinstance(x, tuple)))
    assert sum(p.numel() for p in tm.parameters()) == n_ref
    # gradients of every leaf (the embedding table's too) through the fused
    # LSTM call, against jax.grad
    R = rng.randn(*want.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_grads = jax.jit(jax.grad(lambda p: jnp.sum(
            jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask)) * R)))(v["params"])
    (tm(torch.from_numpy(ids), torch.from_numpy(mask)) * torch.from_numpy(R)).sum().backward()
    paths = flax_paths(tm)
    for name, p in tm.named_parameters():
        path, transposed = paths[name]
        w = np.asarray(tree_get(want_grads, path))
        g = t2n(p.grad).T if transposed else t2n(p.grad)
        assert float(np.abs(w).max()) > 1e-3, name
        np.testing.assert_allclose(g, w, atol=ATOL * max(1.0, float(np.abs(w).max())),
                                   rtol=0, err_msg=name)
    assert len(paths) == 1 + 8 + 4          # the table, eight kernels, four biases


def test_lang_module_lstm_matches_reference():
    """Situation and question of different lengths (separate passes) and of
    equal ones (one pass over both)."""
    jcfg, tcfg = tiny_cfgs(LSTM)
    rng = np.random.RandomState(1)
    s_ids, s_mask = _ids(rng, tcfg.lang, 3, 10, [10, 6, 2])
    q_ids, q_mask = _ids(rng, tcfg.lang, 3, 7, [7, 3, 5])
    jm = JLangModule(jcfg.lang, model="lstm")
    args = tuple(map(jnp.asarray, (s_ids, s_mask, q_ids, q_mask)))
    v = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), *args), rng)
    tm = load_into_port(LangModule(tcfg.lang, model="lstm"), v)
    for a in (args, args[:2] + args[:2]):
        with jax.default_matmul_precision("highest"):
            want = jax.jit(jm.apply)(v, *a)
        with torch.no_grad():
            got = tm(*(torch.from_numpy(np.array(x)) for x in a))
        for g, w in zip(got, want):
            if g.dtype == torch.bool:
                np.testing.assert_array_equal(t2n(g), np.asarray(w))
            else:
                np.testing.assert_allclose(t2n(g), np.asarray(w), atol=ATOL, rtol=0)


def test_lstm_encoder_drops_its_embeddings_in_training():
    """Element-wise dropout on the embeddings in training (a seeded mask),
    none in evaluation."""
    _, tcfg = tiny_cfgs(LSTM)
    torch.manual_seed(0)
    tm = GloveLSTMEncoder(tcfg.lang)
    ids, mask = _ids(np.random.RandomState(2), tcfg.lang, 2, 6, [6, 6])
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        ev = tm(ids, mask)
        a = tm(ids, mask, train=True, generator=torch.Generator().manual_seed(3))
        b = tm(ids, mask, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(ev, tm(ids, mask)) and torch.equal(a, b) and not torch.equal(a, ev)


def test_sig3d_with_the_lstm_encoder_matches_reference():
    """The tiny SIG3D with ``model.lang_model=lstm``: answer scores within
    1e-5 of the reference's. The scene tower is the mpnet model's (held by
    ``test_torch_sig3d.py``); both run on the same pooled scene tokens, the
    serving path, which spares the reference a UNet compile."""
    jcfg, tcfg = tiny_cfgs(LSTM)
    rng = np.random.RandomState(3)
    batch = scene_batch(rng, tcfg, 2)
    jmodel = jsig.SIG3D(jcfg, num_answers=12)
    variables = random_variables(jmodel, batch, rng)
    N, C = tcfg.model.num_scene_tokens, tcfg.model.scene_feat_dim
    served = {k: v for k, v in batch.items() if not k.startswith("voxel_")}
    served["scene_tokens"] = rng.randn(2, N, C).astype(np.float32)
    served["scene_token_positions"] = (rng.rand(2, N, 2) * 4).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, served)
    tmodel = load_into_port(tsig.SIG3D(tcfg, 12, device="cpu"), variables)
    with torch.no_grad():
        got = tmodel(served)
    for k in ("answer_scores", "aux_scores"):
        w = np.asarray(want[k])
        assert float(np.abs(w).max()) > 1e-3, k
        np.testing.assert_allclose(t2n(got[k]), w, atol=ATOL, rtol=0, err_msg=k)
    # the default recipe freezes the whole LSTM encoder in both packages
    mask = sig3d_trainable_mask(tcfg, tmodel)
    assert not any(v for n, v in mask.items() if n.startswith("lang_net."))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(variables["params"]))
    assert trainable_count(tmodel, mask)[1] == n_ref


def test_unknown_language_model_raises():
    _, tcfg = tiny_cfgs()
    with pytest.raises(ValueError, match="unknown lang_model"):
        LangModule(tcfg.lang, model="glove")
