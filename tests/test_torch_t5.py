"""The port's T5 (``situation3d_tpu_torch/models/t5.py``) against the JAX
package's at a tiny width (2 + 2 layers, d_model 64, 4 heads x 16, d_ff 128,
vocabulary 128, 8 answer slots), float32, weights carried over by
``load_jax_variables``; the JAX side under one ``jax.jit`` at full float32
matmul precision.

Tolerances: logits within 1e-5 of the largest logit (the same float32 sums
in another order); decoded tokens equal, token for token: greedy, beam
search (3 beams) and nucleus sampling with JAX's Gumbel draws injected.

In bfloat16 compute on the same float32 parameters, the decode that reads
the cross-attention keys and values projected once a batch, and the weight
copies, equals bit for bit the step that projected them from the encoder
output and cast every weight at every call (written out here).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.models import t5 as jt5
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.models import layers
from situation3d_tpu_torch.models import t5 as tt5
from torch_port_util import blip2_cfgs, random_variables_of, t2n, to_numpy_tree

torch.set_num_threads(1)
LOGIT_RTOL = 1e-5
B, LE, LD, MAX_LEN = 3, 10, 6, 8
START, EOS, PAD = 0, 1, 0


def _jit(fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = blip2_cfgs()
    c = jcfg.blip2.t5
    rng = np.random.RandomState(0)
    emb = rng.randn(B, LE, c.d_model).astype(np.float32)
    emask = (np.arange(LE)[None] < np.array([10, 7, 4])[:, None]).astype(np.int32)
    dec = rng.randint(0, c.vocab_size, (B, LD)).astype(np.int32)
    dmask = (np.arange(LD)[None] < np.array([6, 4, 2])[:, None]).astype(np.int32)
    jm = jt5.T5ForConditionalGeneration(c)
    v = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), emb, emask, dec, dmask),
                            rng)
    # a second set of weights whose EOS column is scaled up, so that rows end
    # early and the stopping rules run
    p = jax.tree_util.tree_map(np.array, to_numpy_tree(v["params"]))
    p["lm_head"]["kernel"][:, EOS] *= 2.5
    v_eos = {"params": jax.tree_util.tree_map(jnp.asarray, p)}
    port = {}
    for name, variables in (("plain", v), ("eos", v_eos)):
        m = tt5.T5ForConditionalGeneration(tcfg.blip2.t5)
        assert load_jax_variables(m, to_numpy_tree(variables["params"]), {}) == []
        port[name] = m
    return {"jm": jm, "v": {"plain": v, "eos": v_eos}, "port": port, "emb": emb,
            "emask": emask, "dec": dec, "dmask": dmask, "cfg": c, "greedy": {}}


def _t(x, long=False):
    t = torch.from_numpy(np.asarray(x))
    return t.long() if long else t


def test_logits_match_reference(ref):
    jm, v = ref["jm"], ref["v"]["plain"]
    want = _jit(lambda v: jm.apply(v, ref["emb"], ref["emask"], ref["dec"], ref["dmask"]), v)
    got = t2n(ref["port"]["plain"](_t(ref["emb"]), _t(ref["emask"]), _t(ref["dec"], True),
                                   _t(ref["dmask"])))
    assert got.shape == (B, LD, ref["cfg"].vocab_size)
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


def test_loss_pieces_match_reference(ref):
    """``shift_right``, ``t5_cross_entropy`` and the repetition penalty."""
    rng = np.random.RandomState(3)
    labels = np.where(ref["dmask"] > 0, ref["dec"], -100).astype(np.int32)
    np.testing.assert_array_equal(
        t2n(tt5.shift_right(_t(labels, True), START, PAD)),
        np.asarray(jt5.shift_right(jnp.asarray(labels), START, PAD)))
    logits = rng.randn(B, LD, 128).astype(np.float32) * 3
    np.testing.assert_allclose(
        float(tt5.t5_cross_entropy(_t(logits), _t(labels, True), _t(ref["dmask"]))),
        float(jt5.t5_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(ref["dmask"]))), rtol=1e-6)
    seen = rng.rand(B, 128) < 0.3
    np.testing.assert_array_equal(
        t2n(tt5.apply_repetition_penalty(_t(logits[:, 0]), _t(seen), 1.3)),
        np.asarray(jt5.apply_repetition_penalty(jnp.asarray(logits[:, 0]),
                                                jnp.asarray(seen), 1.3)))


def test_decode_step_through_the_cache_matches_the_full_decode(ref):
    """Step by step through the 8-slot cache, the logits of each position
    equal the teacher-forced decode's (no decoder mask), as in the
    reference; the cache index advances one a step."""
    m = ref["port"]["plain"]
    emb, emask = _t(ref["emb"]), _t(ref["emask"])
    dec = _t(ref["dec"], True)
    with torch.no_grad():
        enc = m.encode(emb, emask)
        full = t2n(m.decode_train(enc, emask, dec, torch.ones(B, LD, dtype=torch.int32)))
        cache = m.init_cache(B)
        steps = [t2n(m.decode_step(enc, emask, dec[:, i:i + 1], cache))[:, 0]
                 for i in range(LD)]
    assert cache.index == LD and cache.layers[0]["key"].shape == (B, 4, MAX_LEN, 16)
    got = np.stack(steps, 1)
    assert np.abs(got - full).max() <= LOGIT_RTOL * np.abs(full).max()


def _plain_greedy(m, emb, emask, max_len):
    """The plain greedy loop: a fresh cache, ``torch.where`` with a tensor
    fill, new ``done`` and ``tok`` tensors and the flag read a step."""
    B = emb.shape[0]
    enc = m.encode(emb, emask)
    cache = m.init_cache(B)
    out = torch.full((B, max_len), PAD, dtype=torch.long)
    tok = torch.full((B, 1), START, dtype=torch.long)
    done = torch.zeros(B, dtype=torch.bool)
    for i in range(max_len):
        nxt = m.decode_step(enc, emask, tok, cache)[:, -1].argmax(-1)
        nxt = torch.where(done, torch.full_like(nxt, PAD), nxt)
        out[:, i] = nxt
        done = done | (nxt == EOS)
        tok = nxt[:, None]
        if i + 1 < max_len and bool(done.all()):
            break
    return out


def _steps_on_buffers(m, emb, emask, max_len):
    """``greedy_step`` on one set of static buffers for every step, past the
    early exit too: the body a captured decode replays, run eagerly."""
    enc = m.encode(emb, emask)
    b = tt5.GreedyBuffers(m, enc, emask, max_len)
    b.load(enc, emask, START, PAD)
    for i in range(max_len):
        tt5.greedy_step(m, b, i, EOS, PAD, i + 1 < max_len)
    return b.out


@pytest.mark.parametrize("weights,max_len,how", [
    pytest.param(w, n, how, id=f"{w}-{n}" + ("" if how == "greedy_decode" else f"-{how}"))
    for how in ("greedy_decode", "steps_on_buffers")
    for w, n in (("plain", MAX_LEN), ("eos", MAX_LEN), ("plain", MAX_LEN + 3))])
def test_greedy_tokens_equal_reference(ref, weights, max_len, how):
    """Past the 8 cache slots (``max_len`` 11) the reference clamps the write
    and the bias row to the last slot; the port does the same. The step
    function on its static buffers emits the same tokens as the plain loop,
    and on the CPU nothing is captured or replayed."""
    jm, v = ref["jm"], ref["v"][weights]
    if (weights, max_len) not in ref["greedy"]:     # one reference decode for both ways
        ref["greedy"][weights, max_len] = _jit(lambda v: jt5.greedy_decode(
            jm, v, ref["emb"], ref["emask"], max_len, START, EOS, PAD), v)
    want = ref["greedy"][weights, max_len]
    m, emb, emask = ref["port"][weights], _t(ref["emb"]), _t(ref["emask"])
    counts = (tt5.decode_graph_captures, tt5.decode_graph_replays)
    with torch.no_grad():
        if how == "greedy_decode":
            got = tt5.greedy_decode(m, emb, emask, max_len, START, EOS, PAD)
        else:
            got = _steps_on_buffers(m, emb, emask, max_len)
        plain = _plain_greedy(m, emb, emask, max_len)
    np.testing.assert_array_equal(t2n(got), want)
    np.testing.assert_array_equal(t2n(plain), want)
    assert (tt5.decode_graph_captures, tt5.decode_graph_replays) == counts == (0, 0)
    assert not m.decode_graphs.keys
    if weights == "eos":   # some row ended early, padded after its EOS
        assert (want == EOS).any() and (want[:, -1] == PAD).any()


def test_where_neg_equals_the_tensor_fill():
    """``_where_neg`` makes its fill on the scores' device: bit for bit the
    ``torch.where`` with a host ``NEG_INF`` tensor, on the decode's slot
    mask, the causal mask and a key mask."""
    g = torch.Generator().manual_seed(5)
    scores = torch.randn(B, 4, 1, MAX_LEN, generator=g) * 30
    keeps = [(torch.arange(MAX_LEN) <= 3)[None, None, None],
             torch.ones(MAX_LEN, MAX_LEN, dtype=torch.bool).tril()[None, None, :1],
             torch.rand(B, MAX_LEN, generator=g)[:, None, None, :] < 0.5]
    for keep in keeps:
        old = torch.where(keep, scores, torch.tensor(tt5.NEG_INF, dtype=scores.dtype))
        new = tt5._where_neg(keep, scores)
        assert new.dtype == old.dtype and torch.equal(new.view(torch.int32),
                                                      old.view(torch.int32))
        assert (new == tt5.NEG_INF).any() and (new != tt5.NEG_INF).any()


def test_decode_storage_moves_with_a_swapped_storage_only(ref):
    """The captured steps read the weights through their addresses: the
    storage fingerprint stays under an in-place update (an optimizer step)
    and changes where a parameter's storage is swapped (``.data``, an
    assigning ``load_state_dict``); a copy of the model keeps no graph."""
    m = copy.deepcopy(ref["port"]["plain"])
    assert isinstance(m.decode_graphs, tt5.DecodeGraphs) and not m.decode_graphs.keys
    base = tt5.decode_storage(m)
    assert len(base) == len(list(m.decoder.parameters())) + 2 and len(set(base)) == len(base)
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(1.5).add_(0.25)
    assert tt5.decode_storage(m) == base
    w = m.decoder.block1.ff.wo.weight
    w.data = w.data.clone()
    swapped = tt5.decode_storage(m)
    assert swapped != base
    assert sum(a != b for a, b in zip(swapped, base)) == 1
    m.load_state_dict({k: v.clone() for k, v in m.state_dict().items()}, assign=True)
    loaded = tt5.decode_storage(m)
    assert all(a != b for a, b in zip(loaded, swapped))
    e = m.encoder.block0.ff.wo.weight     # the encoder is not read by a step
    e.data = e.data.clone()
    assert tt5.decode_storage(m) == loaded
    assert m.decode_graphs.get(m, torch.zeros(B, LE, 64), _t(ref["emask"]), MAX_LEN,
                               START, EOS, PAD) is None


@pytest.mark.parametrize("weights,min_length,length_penalty", [
    ("plain", 1, 1.0), ("eos", 1, 1.0), ("eos", 3, 0.6)])
def test_beam_tokens_equal_reference(ref, weights, min_length, length_penalty):
    jm, v = ref["jm"], ref["v"][weights]
    want = _jit(lambda v: jt5.beam_search_decode(
        jm, v, ref["emb"], ref["emask"], MAX_LEN, START, EOS, PAD, num_beams=3,
        length_penalty=length_penalty, min_length=min_length), v)
    got = t2n(tt5.beam_search_decode(
        ref["port"][weights], _t(ref["emb"]), _t(ref["emask"]), MAX_LEN, START, EOS, PAD,
        num_beams=3, length_penalty=length_penalty, min_length=min_length))
    np.testing.assert_array_equal(got, want)
    if weights == "eos":
        assert (want == EOS).any()


def _jax_gumbel(key, n, shape):
    """The noise ``jax.random.categorical`` adds at each step of the
    reference's ``sample_decode``: the loop splits its key once a step."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("weights,kw", [
    ("plain", dict(top_p=0.9, temperature=1.0, min_length=1, repetition_penalty=1.0)),
    ("eos", dict(top_p=0.5, temperature=0.7, min_length=2, repetition_penalty=1.3)),
])
def test_sample_tokens_equal_reference_with_its_draws(ref, weights, kw):
    jm, v = ref["jm"], ref["v"][weights]
    key = jax.random.PRNGKey(11)
    want = _jit(lambda v: jt5.sample_decode(jm, v, ref["emb"], ref["emask"], MAX_LEN,
                                            START, EOS, PAD, key, **kw), v)
    got = t2n(tt5.sample_decode(ref["port"][weights], _t(ref["emb"]), _t(ref["emask"]),
                                MAX_LEN, START, EOS, PAD,
                                gumbel=_jax_gumbel(key, MAX_LEN, (B, 128)), **kw))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 3      # the draws picked different tokens


def test_remat_recomputes_blocks_with_the_same_results(ref):
    """``t5.remat`` recomputes each block in the backward: the loss and every
    gradient equal the plain run's (the same arithmetic, run twice)."""
    import dataclasses
    plain = ref["port"]["plain"]
    remat = tt5.T5ForConditionalGeneration(dataclasses.replace(ref["cfg"], remat=True))
    remat.load_state_dict(plain.state_dict())
    labels = _t(np.where(ref["dmask"] > 0, ref["dec"], -100), True)
    grads = []
    for m in (plain, remat):
        m.zero_grad()
        logits = m(_t(ref["emb"]), _t(ref["emask"]), _t(ref["dec"], True), _t(ref["dmask"]))
        tt5.t5_cross_entropy(logits, labels, _t(ref["dmask"])).backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def _bf16(m):
    """The tiny T5 computing in bfloat16 on the same float32 parameters."""
    b = tt5.T5ForConditionalGeneration(m.cfg, dtype=torch.bfloat16)
    b.load_state_dict(m.state_dict())
    return b


def _per_step_projection(m, enc, emask, tok, cache):
    """A decode step as the decoder ran before it kept the cross-attention's
    keys and values: each layer projects them from ``enc`` at every step
    and the mask is converted there; with grad on, every (trainable) Dense
    casts its weight at every call."""
    with torch.enable_grad():
        x = m.shared(tok).to(m.dtype)
        bias = None
        for i in range(m.cfg.num_decoder_layers):
            blk = getattr(m.decoder, f"block{i}")
            a, bias = blk.self_attn(blk.self_attn_norm(x), position_bias=bias,
                                    cache=cache.layers[i], cache_index=cache.index)
            x = x + a
            c, _ = blk.cross_attn(blk.cross_attn_norm(x), kv=enc, mask=emask)
            x = blk.ff(x + c)
        cache.index += x.shape[1]
        return m._logits(m.decoder.final_norm(x)).detach()


@pytest.mark.parametrize("weights", ["plain", "eos"])
def test_greedy_steps_on_the_buffers_equal_the_per_step_projection(ref, weights):
    """Each greedy step's logits on the static buffers (keys and values
    projected once, at ``load``) bit-equal the per-step projection's, in
    bfloat16; the tokens too."""
    m = _bf16(ref["port"][weights])
    emb, emask = _t(ref["emb"]), _t(ref["emask"])
    with torch.no_grad():
        enc = m.encode(emb, emask)
        n0 = tt5.cross_kv_projections
        b = tt5.GreedyBuffers(m, enc, emask, MAX_LEN)
        b.load(enc, emask, START, PAD)
        got = [tt5.greedy_step(m, b, i, EOS, PAD, True) for i in range(MAX_LEN)]
    assert tt5.cross_kv_projections == n0 + 1
    c0 = layers.weight_copies
    cache = m.init_cache(B)
    out = torch.full((B, MAX_LEN), PAD, dtype=torch.long)
    tok = torch.full((B, 1), START, dtype=torch.long)
    done = torch.zeros(B, dtype=torch.bool)
    for i in range(MAX_LEN):
        want = _per_step_projection(m, enc, emask, tok, cache)
        assert torch.equal(got[i].view(torch.int16), want.view(torch.int16)), i
        nxt = want[:, -1].argmax(-1).masked_fill(done, PAD)
        out[:, i] = nxt
        done |= nxt == EOS
        tok = nxt[:, None]
    assert layers.weight_copies == c0        # the written-out step cast every weight
    assert torch.equal(b.out, out)
    with torch.no_grad():
        assert torch.equal(tt5.greedy_decode(m, emb, emask, MAX_LEN, START, EOS, PAD), out)
    assert tt5.cross_kv_projections == n0 + 2
    if weights == "eos":
        assert (out == EOS).any()


@pytest.mark.parametrize("how", ["beam", "sample"])
def test_decoded_tokens_equal_the_per_step_projection(ref, how, monkeypatch):
    """3-beam and sampled tokens in bfloat16 equal the decode whose every
    step projects the keys and values anew (``decode_step`` swapped for the
    written-out step); one projection a decoded batch. (Greedy: the test
    above.)"""
    m = _bf16(ref["port"]["eos"])
    emb, emask = _t(ref["emb"]), _t(ref["emask"])
    gumbel = tt5.gumbel_noise((MAX_LEN, B, 128), torch.Generator().manual_seed(7), "cpu")
    run = {"beam": lambda: tt5.beam_search_decode(m, emb, emask, MAX_LEN, START, EOS, PAD,
                                                  num_beams=3),
           "sample": lambda: tt5.sample_decode(m, emb, emask, MAX_LEN, START, EOS, PAD,
                                               top_p=0.7, gumbel=gumbel)}[how]
    n0 = tt5.cross_kv_projections
    got = run()
    assert tt5.cross_kv_projections == n0 + 1
    monkeypatch.setattr(m, "decode_step", functools.partial(_per_step_projection, m))
    want = run()
    assert tt5.cross_kv_projections == n0 + 1
    np.testing.assert_array_equal(t2n(got), t2n(want))
    assert len(np.unique(t2n(want))) > 3


def test_reorder_moves_the_cross_keys_and_values_with_their_rows(ref):
    """Beam search's ``reorder`` keeps the projected keys, values and mask
    of the rows it keeps, as it does the self-attention slots."""
    m = ref["port"]["plain"]
    emb, emask = _t(ref["emb"]), _t(ref["emask"])
    rows = torch.tensor([2, 0, 0])
    with torch.no_grad():
        enc = m.encode(emb, emask)
        cache = m.init_cache(B)
        m.decode_step(enc, emask, torch.full((B, 1), START, dtype=torch.long), cache)
        before = [(k.clone(), v.clone()) for k, v in cache.cross]
        cache.reorder(rows)
    assert len(cache.cross) == m.cfg.num_decoder_layers
    for (k, v), (k0, v0) in zip(cache.cross, before):
        assert k.dtype == torch.float32 and k.shape == (B, LE, 64)
        assert torch.equal(k, k0[rows]) and torch.equal(v, v0[rows])
    assert torch.equal(cache.cross_mask, _t(ref["emask"])[rows].bool())
