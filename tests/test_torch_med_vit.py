"""The BLIP-1-era zoo in the port (``models/med.py``, ``models/vit.py``,
``ckpt_compat/{med,vit}.py``) against the JAX package at tiny widths (MED 2
layers at 16 with cross-attention into a 12-d width; EVA, CLIP and ViT-B 2
blocks at 24 over 28-32 pixel images), float32, weights carried over by
``load_jax_variables``; the JAX side at full float32 matmul precision.

Tolerances: outputs within 1e-5 of their largest value; the LM loss within
1e-5 (relative); the resized position embedding within 1e-6 of the largest;
converted trees equal to the JAX converters' bit for bit (1e-6 where the
position embedding is resized).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ckpt_compat import med as jmed_ckpt
from situation3d_tpu.ckpt_compat import vit as jvit_ckpt
from situation3d_tpu.models import med as jmed
from situation3d_tpu.models import vit as jvit
from situation3d_tpu_torch.ckpt_compat import med as tmed_ckpt
from situation3d_tpu_torch.ckpt_compat import vit as tvit_ckpt
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.models import med as tmed
from situation3d_tpu_torch.models import vit as tvit
from torch_port_util import load_into_port, random_variables_of, t2n, to_numpy_tree

torch.set_num_threads(1)
RTOL = 1e-5
MED = dict(vocab_size=57, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=37,
           max_position_embeddings=32, encoder_width=12)
VITS = {  # name: (config fields, image size)
    "eva": (dict(model_name="eva_clip_g", img_size=28, patch_size=7, embed_dim=24, depth=2,
                 num_heads=4, mlp_ratio=2.5, use_shared_rel_pos_bias=True), 28),
    "clip": (dict(model_name="clip_L", img_size=28, patch_size=7, embed_dim=24, depth=2,
                  num_heads=4, mlp_ratio=4.0, layer_norm_eps=1e-5), 28),
    "vit_base": (dict(model_name="vit_base", img_size=32, patch_size=8, embed_dim=24, depth=2,
                      num_heads=4, mlp_ratio=4.0, full_qkv_bias=True, final_norm=True), 32),
}


def _close(got, want, rtol, what=""):
    err, scale = np.abs(np.asarray(got) - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (what, err, scale)


def _jit(fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _tree_equal(got, want, atol=0.0):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and np.abs(np.asarray(g) - w).max(initial=0) <= atol


@pytest.fixture(scope="module")
def med_ref():
    rng = np.random.RandomState(0)
    B, L, N = 2, 7, 5
    ids = rng.randint(0, MED["vocab_size"], (B, L))
    am = np.ones((B, L), np.int32)
    am[1, 5:] = 0
    tt = (np.arange(L)[None] >= 4).astype(np.int32).repeat(B, 0)
    enc = rng.randn(B, N, MED["encoder_width"]).astype(np.float32)
    enc_m = np.ones((B, N), np.int32)
    enc_m[0, 3:] = 0
    kw = dict(token_type_ids=tt, encoder_hidden_states=enc, encoder_attention_mask=enc_m)
    jb, jlm = jmed.MedBertModel(jmed.MedConfig(**MED)), jmed.MedBertLMHeadModel(
        jmed.MedConfig(**MED))
    vb = random_variables_of(lambda: jb.init(jax.random.PRNGKey(0), ids, am, **kw), rng)
    vl = random_variables_of(lambda: jlm.init(jax.random.PRNGKey(1), ids, am, **kw), rng)
    labels = np.where(am > 0, ids, -100)
    out = _jit(lambda vb, vl: {
        mode: jb.apply(vb, ids, am, mode=mode, **kw) for mode in ("text", "multimodal")} | {
        "lm": jlm.apply(vl, ids, am, **kw)}, vb, vl)
    out["lm_loss"] = np.asarray(jmed.MedBertLMHeadModel.lm_loss(jnp.asarray(out["lm"]), labels))
    return {"ids": ids, "am": am, "kw": kw, "vb": vb, "vl": vl, "labels": labels, "out": out}


def test_med_both_modes_match_reference(med_ref):
    r = med_ref
    m = load_into_port(tmed.MedBertModel(tmed.MedConfig(**MED), device="cpu"), r["vb"])
    kw = {k: torch.from_numpy(v) for k, v in r["kw"].items()}
    ids, am = torch.from_numpy(r["ids"]), torch.from_numpy(r["am"])
    with torch.no_grad():
        for mode in ("text", "multimodal"):
            seq, pooled = m(ids, am, mode=mode, **kw)
            _close(t2n(seq), r["out"][mode][0], RTOL, mode)
            _close(t2n(pooled), r["out"][mode][1], RTOL, mode + " pooled")
    assert not np.allclose(r["out"]["text"][0], r["out"]["multimodal"][0])


def test_med_lm_head_and_loss_match_reference(med_ref):
    r = med_ref
    m = load_into_port(tmed.MedBertLMHeadModel(tmed.MedConfig(**MED), device="cpu"), r["vl"])
    assert m.bert.cfg.is_decoder and m.bert.pooler is None
    kw = {k: torch.from_numpy(v) for k, v in r["kw"].items()}
    with torch.no_grad():
        logits = m(torch.from_numpy(r["ids"]), torch.from_numpy(r["am"]), **kw)
    _close(t2n(logits), r["out"]["lm"], RTOL, "lm logits")
    loss = float(tmed.MedBertLMHeadModel.lm_loss(torch.tensor(r["out"]["lm"]),
                                                 torch.from_numpy(r["labels"])))
    assert abs(loss - float(r["out"]["lm_loss"])) <= RTOL * float(r["out"]["lm_loss"])


def _vit_pair(name):
    fields, img = VITS[name]
    jcfg, tcfg = jvit.ViTConfig(**fields), tvit.ViTConfig(**fields)
    jcls, tcls = (jvit.ClipViT, tvit.ClipViT) if name == "clip" else (jvit.EvaViT, tvit.EvaViT)
    return jcls(jcfg), tcfg, tcls, img


@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_forward_matches_reference(name):
    jm, tcfg, tcls, img = _vit_pair(name)
    rng = np.random.RandomState(5)
    images = rng.rand(2, img, img, 3).astype(np.float32)
    v = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), images), rng)
    want = _jit(lambda v: jm.apply(v, images), v)
    m = load_into_port(tcls(tcfg, device="cpu"), v)
    with torch.no_grad():
        got = m(torch.from_numpy(images))
    assert got.shape == want.shape == (2, 1 + tcfg.num_patches, 24)
    _close(t2n(got), want, RTOL, name)


def test_drop_path_and_remat():
    """Training-form drop path draws its masks from the generator (the same
    seed, the same output; other than inference); ``remat`` recomputes the
    blocks in the backward to the same gradients."""
    fields = dict(VITS["eva"][0], drop_path_rate=0.5)
    x = torch.from_numpy(np.random.RandomState(6).rand(3, 28, 28, 3).astype(np.float32))
    grads, outs = [], []
    for remat in (False, True):
        m = tvit.EvaViT(tvit.ViTConfig(**fields, remat=remat), device="cpu", seed=1)
        out = m(x, train=True, generator=torch.Generator().manual_seed(3))
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad.clone() for p in m.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-7) for a, b in zip(*grads))
    with torch.no_grad():
        assert not torch.equal(m(x), outs[0])
        assert torch.equal(m(x, train=True, generator=torch.Generator().manual_seed(3)), outs[0])


def test_configs_and_vision_encoder_surface():
    for make in ("eva_clip_g", "clip_L", "vit_base"):
        assert dataclasses.asdict(getattr(tvit.ViTConfig, make)()) == \
            dataclasses.asdict(getattr(jvit.ViTConfig, make)())
    assert dataclasses.asdict(tmed.MedConfig()) == dataclasses.asdict(jmed.MedConfig())
    with pytest.raises(ValueError, match="eva_clip_g or clip_L"):
        tvit.init_vision_encoder("vit_h", device="cpu")
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            tvit.init_vision_encoder("clip_L")


@pytest.mark.parametrize("old,new", [(4, 6), (6, 3), (5, 5)])
def test_interpolate_pos_embed_matches_reference(old, new):
    pos = np.random.RandomState(old).randn(1, 1 + old * old, 8).astype(np.float32)
    want = np.asarray(jvit.interpolate_pos_embed(pos, new * new))
    got = t2n(tvit.interpolate_pos_embed(pos, new * new))
    assert got.shape == want.shape == (1, 1 + new * new, 8)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _vit_state_dict(kind, C, depth, grid, rng):
    P = 7
    if kind == "clip":
        sd = {"conv1.weight": rng.randn(C, 3, P, P), "class_embedding": rng.randn(C),
              "positional_embedding": rng.randn(1 + grid * grid, C),
              "ln_pre.weight": rng.rand(C), "ln_pre.bias": rng.randn(C)}
        for i in range(depth):
            b = f"transformer.resblocks.{i}"
            sd.update({f"{b}.attn.in_proj_weight": rng.randn(3 * C, C),
                       f"{b}.attn.in_proj_bias": rng.randn(3 * C)})
            for n, shape in (("attn.out_proj", (C, C)), ("mlp.c_fc", (4 * C, C)),
                             ("mlp.c_proj", (C, 4 * C))):
                sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = rng.randn(*shape), rng.randn(shape[0])
            for n in ("ln_1", "ln_2"):
                sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = rng.rand(C), rng.randn(C)
        return {"visual." + k: v.astype(np.float32) for k, v in sd.items()}
    sd = {"patch_embed.proj.weight": rng.randn(C, 3, P, P), "patch_embed.proj.bias": rng.randn(C),
          "cls_token": rng.randn(1, 1, C), "pos_embed": rng.randn(1, 1 + grid * grid, C)}
    if kind == "timm":
        sd["norm.weight"], sd["norm.bias"] = rng.rand(C), rng.randn(C)
    for i in range(depth):
        b = f"blocks.{i}"
        sd[f"{b}.attn.qkv.weight"] = rng.randn(3 * C, C)
        if kind == "timm":
            sd[f"{b}.attn.qkv.bias"] = rng.randn(3 * C)
        else:
            sd[f"{b}.attn.q_bias"], sd[f"{b}.attn.v_bias"] = rng.randn(C), rng.randn(C)
        for n, shape in (("attn.proj", (C, C)), ("mlp.fc1", (2 * C, C)), ("mlp.fc2", (C, 2 * C))):
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = rng.randn(*shape), rng.randn(shape[0])
        for n in ("norm1", "norm2"):
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = rng.rand(C), rng.randn(C)
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("kind", ["eva", "timm", "clip"])
def test_vit_converters_equal_reference(kind):
    """The converted trees equal JAX's, as they stand and resized from a 5 x 5
    to the 4 x 4 patch grid; the stand-size tree fills a port model."""
    conv = {"eva": "convert_eva_vit", "timm": "convert_timm_vit", "clip": "convert_clip_vit"}[kind]
    trees = []
    for grid, num_patches, atol in ((4, None, 0.0), (5, 16, 1e-6)):
        sd = _vit_state_dict(kind, 8, 2, grid, np.random.RandomState(grid))
        trees.append(getattr(tvit_ckpt, conv)(sd, depth=2, num_patches=num_patches))
        want = to_numpy_tree(getattr(jvit_ckpt, conv)(sd, depth=2, num_patches=num_patches))
        _tree_equal(trees[-1], want, atol)
    fields = dict(img_size=28, patch_size=7, embed_dim=8, depth=2, num_heads=2,
                  mlp_ratio=4.0 if kind == "clip" else 2.0, full_qkv_bias=kind == "timm",
                  final_norm=kind == "timm")
    m = (tvit.ClipViT if kind == "clip" else tvit.EvaViT)(tvit.ViTConfig(**fields), device="cpu")
    for tree in trees:
        assert load_jax_variables(m, tree, {}) == []


def _bert_state_dict(cfg, rng, lm_head):
    H, I, W, V = cfg.hidden_size, cfg.intermediate_size, cfg.encoder_width, cfg.vocab_size
    pre = "bert." if lm_head else ""
    sd = {f"{pre}embeddings.word_embeddings.weight": rng.randn(V, H),
          f"{pre}embeddings.position_embeddings.weight": rng.randn(cfg.max_position_embeddings, H),
          f"{pre}embeddings.token_type_embeddings.weight": rng.randn(2, H),
          f"{pre}embeddings.LayerNorm.weight": rng.rand(H),
          f"{pre}embeddings.LayerNorm.bias": rng.randn(H)}

    def dense(name, n_out, n_in):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = rng.randn(n_out, n_in), rng.randn(n_out)

    def norm(name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = rng.rand(H), rng.randn(H)

    for i in range(cfg.num_layers):
        b = f"{pre}encoder.layer.{i}"
        for kind, kv in (("attention", H), ("crossattention", W)):
            dense(f"{b}.{kind}.self.query", H, H)
            dense(f"{b}.{kind}.self.key", H, kv)
            dense(f"{b}.{kind}.self.value", H, kv)
            dense(f"{b}.{kind}.output.dense", H, H)
            norm(f"{b}.{kind}.output.LayerNorm")
        dense(f"{b}.intermediate.dense", I, H)
        dense(f"{b}.output.dense", H, I)
        norm(f"{b}.output.LayerNorm")
    if lm_head:
        dense("cls.predictions.transform.dense", H, H)
        norm("cls.predictions.transform.LayerNorm")
        sd["cls.predictions.decoder.weight"] = rng.randn(V, H)
        sd["cls.predictions.bias"] = rng.randn(V)
    else:
        dense("pooler.dense", H, H)
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("lm_head", [False, True])
def test_med_converters_equal_reference(lm_head):
    cfg = tmed.MedConfig(**MED)
    sd = _bert_state_dict(cfg, np.random.RandomState(7), lm_head)
    if lm_head:
        got, want = tmed_ckpt.convert_med_lm(sd, 2), jmed_ckpt.convert_med_lm(sd, 2)
        m = tmed.MedBertLMHeadModel(cfg, device="cpu")
    else:
        got = tmed_ckpt.convert_med_bert(sd, 2, prefix="")
        want = jmed_ckpt.convert_med_bert(sd, 2, prefix="")
        m = tmed.MedBertModel(cfg, device="cpu")
    _tree_equal(got, to_numpy_tree(want))
    assert load_jax_variables(m, got, {}) == []
