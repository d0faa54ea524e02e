"""OPT and Blip2OPT in the port (``models/opt.py``, ``models/blip2_opt.py``,
``ckpt_compat/opt.py``) against the JAX package at a tiny width (OPT 2
layers at 32, 4 heads, vocabulary 128; Q-Former 2 layers at 16 with 4
queries over 50-d scene features, so the position tokens carry 2 zero
channels), float32, weights carried over by ``load_jax_variables``; the
JAX side at full float32 matmul precision.

Tolerances: logits within 1e-5 of the largest; losses within 1e-5
(relative); greedy tokens equal (ragged left-padded prompts, and a row that
stops at the end token); the converted tree equal to the JAX converter's bit
for bit.
"""
import jax
import numpy as np
import pytest
import torch

from situation3d_tpu.ckpt_compat.opt import convert_opt as j_convert_opt
from situation3d_tpu.config import QFormerConfig as JQFormerConfig
from situation3d_tpu.models import blip2_opt as jbo
from situation3d_tpu.models import opt as jopt
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.ckpt_compat.opt import convert_opt
from situation3d_tpu_torch.config import QFormerConfig
from situation3d_tpu_torch.models import blip2_opt as tbo
from situation3d_tpu_torch.models import opt as topt
from torch_port_util import load_into_port, random_variables_of, t2n, to_numpy_tree

torch.set_num_threads(1)
RTOL = 1e-5
QF = dict(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
          num_query_tokens=4, encoder_width=50, vocab_size=50, max_position=16,
          scene_token_capacity=12)
FEAT = 50


def _close(got, want, rtol, what=""):
    err, scale = np.abs(np.asarray(got) - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (what, err, scale)


def _stopped_at(tokens, eos, pad=1):
    """Greedy tokens of a run without an end token, as a run that ends each
    row at its first ``eos`` gives them: that token kept, ``pad`` after it
    (a row's tokens do not depend on the other rows)."""
    out = tokens.copy()
    for r in out:
        hits = np.flatnonzero(r == eos)
        if hits.size:
            r[hits[0] + 1:] = pad
    return out


def _ragged_prompt(rng, B, L, n_real, V=128):
    mask = (np.arange(L)[None] >= L - np.array(n_real)[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.randint(3, V, (B, L)), 1).astype(np.int32)
    return ids, mask


@pytest.fixture(scope="module")
def opt_ref():
    cfg = jopt.OPTConfig.tiny()
    rng = np.random.RandomState(0)
    ids, mask = _ragged_prompt(rng, 3, 7, [7, 5, 2])
    jm = jopt.OPTForCausalLM(cfg)
    params = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), ids, mask), rng)["params"]
    prefix = (rng.randn(3, 4, 32) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        logits = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, ids, mask))(params))
        plogits = np.asarray(jax.jit(lambda p: jm.apply(
            {"params": p}, ids, mask, prefix_embeds=prefix))(params))
        tokens = np.asarray(jopt.opt_greedy_decode(jm, {"params": params}, prefix, ids, 6,
                                                   eos_id=-1, pad_id=1, first_mask=mask))
    tm = load_into_port(topt.OPTForCausalLM(topt.OPTConfig.tiny(), device="cpu"),
                        {"params": params})
    return {"cfg": cfg, "ids": ids, "mask": mask, "params": params, "prefix": prefix,
            "logits": logits, "plogits": plogits, "tokens": tokens, "tm": tm}


def test_opt_logits_match_reference(opt_ref):
    """Left-padded rows (positions from the mask cumsum, pad keys masked),
    with and without an embedding prefix."""
    r, tm = opt_ref, opt_ref["tm"]
    ids, mask = torch.from_numpy(r["ids"]), torch.from_numpy(r["mask"])
    with torch.no_grad():
        _close(t2n(tm(ids, mask)), r["logits"], RTOL, "logits")
        _close(t2n(tm(ids, mask, prefix_embeds=torch.from_numpy(r["prefix"]))),
               r["plogits"], RTOL, "prefix logits")


def test_opt_loss_matches_reference(opt_ref):
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 7, 128).astype(np.float32)
    cases = (np.where(opt_ref["mask"] > 0, opt_ref["ids"], -100).astype(np.int32),
             np.full((3, 7), -100, np.int32))
    wants = jax.jit(lambda: [jopt.opt_causal_lm_loss(logits, t) for t in cases])()
    for targets, want in zip(cases, wants):
        got = float(topt.opt_causal_lm_loss(torch.from_numpy(logits),
                                            torch.from_numpy(targets)))
        assert abs(got - float(want)) <= RTOL * max(abs(float(want)), 1.0), (got, want)


def test_opt_greedy_tokens_match_reference(opt_ref):
    """A ragged left-padded prompt after a 4-token prefix, 6 tokens; then
    with the end token set to the first token row 0 emits (that row stops
    and pads, the others go on)."""
    r, tm = opt_ref, opt_ref["tm"]
    args = (torch.from_numpy(r["prefix"]), torch.from_numpy(r["ids"]))
    got = topt.opt_greedy_decode(tm, *args, 6, eos_id=-1, pad_id=1,
                                 first_mask=torch.from_numpy(r["mask"]))
    np.testing.assert_array_equal(t2n(got), r["tokens"])
    eos = int(r["tokens"][0, 0])
    want = _stopped_at(r["tokens"], eos)
    got = topt.opt_greedy_decode(tm, *args, 6, eos_id=eos, pad_id=1,
                                 first_mask=torch.from_numpy(r["mask"]))
    np.testing.assert_array_equal(t2n(got), want)
    assert (want[0, 1:] == 1).all()


def test_blip2_opt_loss_and_answers_match_reference():
    """The training loss over [prefix ; prompt + answer] with the prompt
    masked, and greedy answers after a ragged prompt that stop at the
    newline id."""
    jq, ocfg = JQFormerConfig(**QF), jopt.OPTConfig.tiny()
    jm = jbo.Blip2OPT(jq, ocfg, pc_feat_dim=FEAT)
    rng = np.random.RandomState(1)
    B, N, L = 3, QF["scene_token_capacity"], 7
    pc_mask = (np.arange(N)[None] < np.array([[12], [7], [3]])).astype(np.int32)
    ids, mask = _ragged_prompt(rng, B, L, [7, 4, 6])
    batch = {"pc_feat": rng.randn(B, N, FEAT).astype(np.float32),
             "pc": rng.randint(-3, 300, (B, N, 3)).astype(np.int32), "pc_mask": pc_mask,
             "input_ids": ids, "input_mask": mask,
             "target_mask": (mask * (np.arange(L)[None] >= 4)).astype(np.int32)}
    variables = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), batch), rng)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v: jm.apply(v, batch))(variables)
        first = np.asarray(jbo.opt_predict_answers(jm, variables, batch, max_len=5, eos_id=-1))
    newline = int(first[1, 1])
    want = _stopped_at(first, newline)
    tm = load_into_port(tbo.Blip2OPT(QFormerConfig(**QF), topt.OPTConfig.tiny(),
                                     pc_feat_dim=FEAT, device="cpu"), variables)
    with torch.no_grad():
        got = tm(batch)
    _close(t2n(got["logits"]), np.asarray(out["logits"]), RTOL, "logits")
    assert abs(float(got["loss"]) - float(out["loss"])) <= RTOL * float(out["loss"])
    np.testing.assert_array_equal(t2n(tbo.opt_predict_answers(tm, batch, 5, eos_id=-1)), first)
    np.testing.assert_array_equal(t2n(tbo.opt_predict_answers(tm, batch, 5, eos_id=newline)),
                                  want)
    # the position tokens' last two channels are zero
    pos = tbo.voxel_position_embedding(torch.from_numpy(batch["pc"]), FEAT, tm.pos_table)
    assert pos.shape[-1] == FEAT and not pos[..., 48:].any()


def _fake_opt_state_dict(cfg, rng, prefix="model.decoder."):
    H, F_ = cfg.hidden_size, cfg.ffn_dim
    sd = {"embed_tokens.weight": rng.randn(cfg.vocab_size, H),
          "embed_positions.weight": rng.randn(cfg.max_position + cfg.pos_offset, H),
          "final_layer_norm.weight": rng.rand(H), "final_layer_norm.bias": rng.randn(H)}
    for i in range(cfg.num_layers):
        b = f"layers.{i}"
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = rng.rand(H), rng.randn(H)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{b}.self_attn.{n}.weight"], sd[f"{b}.self_attn.{n}.bias"] = \
                rng.randn(H, H), rng.randn(H)
        sd[f"{b}.fc1.weight"], sd[f"{b}.fc1.bias"] = rng.randn(F_, H), rng.randn(F_)
        sd[f"{b}.fc2.weight"], sd[f"{b}.fc2.bias"] = rng.randn(H, F_), rng.randn(H)
    out = {prefix + k: v.astype(np.float32) for k, v in sd.items()}
    out["lm_head.weight"] = out[prefix + "embed_tokens.weight"]       # tied
    return out


def test_opt_config_defaults_equal_reference():
    """opt-2.7b: 2,560 wide, 32 layers, 32 heads, FFN 10,240, vocabulary
    50,272, position offset 2."""
    import dataclasses
    assert dataclasses.asdict(topt.OPTConfig()) == dataclasses.asdict(jopt.OPTConfig())
    assert dataclasses.asdict(topt.OPTConfig.tiny(ffn_dim=48)) == \
        dataclasses.asdict(jopt.OPTConfig.tiny(ffn_dim=48))


@pytest.mark.parametrize("prefix", ["model.decoder.", "decoder.", ""])
def test_convert_opt_equals_reference(prefix):
    cfg = topt.OPTConfig.tiny()
    sd = _fake_opt_state_dict(cfg, np.random.RandomState(3), prefix)
    got, want = convert_opt(sd, cfg.num_layers), to_numpy_tree(
        j_convert_opt(sd, cfg.num_layers))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)
    m = topt.OPTForCausalLM(cfg, device="cpu")
    assert load_jax_variables(m, got, {}) == []
    np.testing.assert_array_equal(t2n(m.layer1.fc1.weight), sd[prefix + "layers.1.fc1.weight"])
