"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``):
one tiny configuration for both packages, numpy bridges, and the sampling
draws the JAX model makes from its ``sample`` key."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY = [
    "lang.num_layers=1", "lang.hidden_size=32", "lang.num_heads=2",
    "lang.intermediate_size=64", "lang.vocab_size=128",
    "model.hidden_size=32", "model.mcan_num_heads=2", "model.mcan_num_layers=1",
    "model.mcan_flat_mlp_size=16", "model.mcan_flat_out_size=24",
    "model.num_scene_tokens=8", "model.scene_feat_dim=24",
    "sparse.planes=4,8,12,24,12,12,8,8", "sparse.layers=1,1,1,1,1,1,1,1",
    "sparse.init_dim=4", "sparse.bottleneck_channels=24",
    "sparse.capacities=512,256,128,64,32", "sparse.grid_extent=(128,128,64)",
    "data.voxel_size=0.08", "data.num_answers=12", "data.max_text_len=12",
    # the slice's configuration: conv0 on its k5 map
    "sparse.conv0_zwin=false",
]


def tiny_cfgs(extra=()):
    """(reference Config, port Config) from the same overrides."""
    from situation3d_tpu.config import Config as JConfig, apply_overrides as japply
    from situation3d_tpu_torch.config import Config as TConfig, apply_overrides as tapply
    opts = [*TINY, *extra]
    return japply(JConfig(), opts), tapply(TConfig(), opts)


def to_numpy_tree(tree):
    """A flax variable collection as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def t2n(x):
    return x.detach().cpu().numpy()


def scene_batch(rng, cfg, B, n_vox=300, span=(100, 75, 38), n_text=(9, 5)):
    """One synthetic batch as numpy arrays: unique voxels inside ``span``."""
    cap, L = cfg.sparse.capacities[0], cfg.data.max_text_len
    coords = np.zeros((B, cap, 3), np.int32)
    mask = np.zeros((B, cap), bool)
    feats = np.zeros((B, cap, 3), np.float32)
    for b in range(B):
        c = np.unique(np.stack([rng.randint(0, s, n_vox + 40) for s in span], 1),
                      axis=0)[:n_vox]
        coords[b, :len(c)], mask[b, :len(c)] = c, True
        feats[b, :len(c)] = rng.rand(len(c), 3)
    sm = np.zeros((B, L), np.int32); sm[:, :n_text[0]] = 1
    qm = np.zeros((B, L), np.int32); qm[:, :n_text[1]] = 1
    return {
        "s_ids": rng.randint(2, cfg.lang.vocab_size, (B, L)).astype(np.int32),
        "s_mask": sm,
        "q_ids": rng.randint(2, cfg.lang.vocab_size, (B, L)).astype(np.int32),
        "q_mask": qm,
        "voxel_coords": coords, "voxel_feats": feats, "voxel_mask": mask,
        "auxiliary_task": np.concatenate(
            [rng.rand(B, 3) * 4, np.tile([0, 0, 0, 1.0], (B, 1))], 1).astype(np.float32),
    }


def randomize_variables(variables, rng):
    """Replace flax-initialized variables with seeded numpy draws so biases,
    norm offsets and running statistics are exercised too (zeros and ones
    would hide a swapped or missing leaf)."""
    def fill(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name == "var":
            v = 0.5 + rng.rand(*x.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*x.shape)
        elif name in ("bias", "mean"):
            v = 0.1 * rng.randn(*x.shape)
        else:
            v = np.asarray(x) + 0.0
        return jnp.asarray(v.astype(np.float32))
    return jax.tree_util.tree_map_with_path(fill, variables)


def jax_sample_draws(model, variables, key, B, V, N):
    """The uniform and integer draws the reference ``SIG3D`` forward makes
    for its token sampling from ``rngs={"sample": key}``: the model's
    ``make_rng("sample")`` key, split per sample, then split in two."""
    import flax.linen as nn
    rng = nn.apply(lambda m: m.make_rng("sample"), model)(
        variables, rngs={"sample": key})
    us, dups = [], []
    for k in jax.random.split(rng, B):
        r1, r2 = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(r1, (V,))))
        dups.append(np.asarray(jax.random.randint(
            r2, (N,), 0, jnp.iinfo(jnp.int32).max)))
    return (torch.from_numpy(np.stack(us)),
            torch.from_numpy(np.stack(dups).astype(np.int32)))


def flax_paths(model):
    """``{port parameter name: (reference tree path, transposed)}`` for every
    parameter of a port model, by the converter's own rules."""
    from situation3d_tpu_torch.ckpt_compat.from_jax import _RULES
    out = {}
    for mod_name, mod in model.named_modules():
        for tensor_name, coll, leaf, transpose in _RULES.get(type(mod), ()):
            if coll == "params" and getattr(mod, tensor_name) is not None:
                out[f"{mod_name}.{tensor_name}"] = (tuple(mod_name.split(".")) + (leaf,),
                                                    transpose)
    return out


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def port_grads_as_tree(model, grads_by_name, like):
    """Port gradients (``name -> tensor``) laid out as the reference tree
    ``like`` (missing leaves stay zero), transposed back where the converter
    transposes."""
    paths = flax_paths(model)
    out = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), like)
    for name, g in grads_by_name.items():
        path, tr = paths[name]
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = t2n(g).T if tr else t2n(g)
    return out


def with_targets(rng, batch, num_answers):
    """Adds the training / evaluation targets to a ``scene_batch``."""
    B = len(batch["s_ids"])
    cat = rng.randint(0, num_answers, B)
    scores = np.eye(num_answers, dtype=np.float32)[cat]
    scores[np.arange(B), rng.randint(0, num_answers, B)] = 1.0   # a second answer
    return {**batch, "answer_cat_scores": scores, "answer_cat": cat.astype(np.int32),
            "question_type": rng.randint(0, 9, B).astype(np.int32),
            "sample_valid": np.ones(B, bool)}


def random_variables_of(init_fn, rng):
    """Reference variables without running the initializers: shapes from
    ``jax.eval_shape(init_fn)`` (a function of no arguments that calls
    ``model.init``), values from numpy (fan-in scaled), then
    ``randomize_variables``."""
    shapes = jax.eval_shape(init_fn)
    variables = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.randn(*s.shape)
                               / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(np.float32)),
        shapes)
    return randomize_variables(variables, rng)


def random_variables(jmodel, batch, rng):
    """:func:`random_variables_of` for the reference ``SIG3D`` on ``batch``."""
    return random_variables_of(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "sample": jax.random.PRNGKey(1)}, batch, train=False), rng)


def flax_apply(jmodel, variables, *args, train=False, **kwargs):
    """One jitted ``apply`` under full float32 matmul precision. Returns
    ``(outputs, updated batch_stats or None)``; in training form the batch
    norms use batch statistics and ``batch_stats`` is mutable."""
    def run(v, a):
        if train:
            return jmodel.apply(v, *a, train=True, mutable=["batch_stats"], **kwargs)
        return jmodel.apply(v, *a, **kwargs), {}
    with jax.default_matmul_precision("highest"):
        out, upd = jax.jit(run)(variables, args)
    return out, (to_numpy_tree(upd.get("batch_stats", {})) if train else None)


def load_into_port(model, variables):
    """Carry reference variables into a port module; every leaf must be used."""
    from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
    unused = load_jax_variables(model, to_numpy_tree(variables["params"]),
                                to_numpy_tree(variables.get("batch_stats", {})))
    assert unused == [], unused
    return model


def port_batch_stats(model):
    """``{port buffer name: numpy}`` -> laid out as the reference's
    ``batch_stats`` tree (``a.b.mean`` -> ``tree[a][b][mean]``)."""
    out = {}
    for name, buf in model.named_buffers():
        if name.rsplit(".", 1)[-1] in ("mean", "var"):
            node = out
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t2n(buf)
    return out


# ---------------------------------------------------------------------------
# SQA3D-layout files written on the spot (the layout of
# tests/test_sqa3d_integration.py: OpenScene .pth scenes, ScanNet meta files
# with an axisAlignment line, SQA_{split}.json, answer_counter.json)
# ---------------------------------------------------------------------------

SQA_SCENES = {"scene0000_00": "train", "scene0001_00": "val"}
SQA_ANSWERS = ["yes", "no", "left", "right", "two", "red", "table", "chair",
               "one", "three", "behind", "kitchen"]


def write_small_sqa3d(root, n_points=4000, n_train=8, n_val=4):
    """Two small scenes (uniform points in a 3 x 2.5 x 2 m box, 7 points
    unannotated, an axis alignment of z-rotation + translation each), QA
    records over both and a 12-answer counter. Returns the ``data.*``
    overrides that point a config at them."""
    from scipy.spatial.transform import Rotation as R
    from situation3d_tpu_torch.data.synthetic import write_sqa3d_files
    scenes = {}
    for i, (sid, split) in enumerate(SQA_SCENES.items()):
        rng = np.random.RandomState(i)
        labels = rng.randint(0, 20, n_points).astype(np.int64)
        labels[:7] = -100
        aa = np.eye(4)
        aa[:3, :3] = R.from_euler("z", 0.2 + 0.3 * i).as_matrix()
        aa[:3, 3] = [0.5, -0.25, 0.1]
        scenes[sid] = {"split": split, "labels": labels, "axis_align": aa,
                       "locs": (rng.rand(n_points, 3) * np.array([3.0, 2.5, 2.0])
                                - 1.0).astype(np.float32),
                       "feats": (rng.rand(n_points, 3) * 2 - 1).astype(np.float32)}
    rng = np.random.RandomState(7)

    def records(n, base_qid):
        out = []
        for i in range(n):
            quat = rng.randn(4)
            quat /= np.linalg.norm(quat)
            out.append({
                "scene_id": list(SQA_SCENES)[i % len(SQA_SCENES)],
                "situation": f"I am standing near the {SQA_ANSWERS[i % 6 + 6]}.",
                "question": ["What is behind me?", "Is the door open?",
                             "How many chairs are there?", "Can I sit down?"][i % 4],
                "answers": [SQA_ANSWERS[i % len(SQA_ANSWERS)]],
                "position": list(rng.rand(3) * 0.5) + list(quat),
                "question_id": base_qid + i,
            })
        return out

    counter = {a: 5 - (i % 3) for i, a in enumerate(SQA_ANSWERS)}
    return write_sqa3d_files(str(root), scenes,
                             {"train": records(n_train, 1000), "val": records(n_val, 2000)},
                             counter)


def assert_batches_equal(got, want):
    """Two numpy batch dicts: the same keys, dtypes and values, bit for bit."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# The 3D-LLM (BLIP-2 + T5) at a tiny width
# ---------------------------------------------------------------------------

BLIP2_TINY = [
    "blip2.t5.vocab_size=128", "blip2.t5.d_model=64", "blip2.t5.d_kv=16",
    "blip2.t5.d_ff=128", "blip2.t5.num_layers=2", "blip2.t5.num_decoder_layers=2",
    "blip2.t5.num_heads=4", "blip2.t5.max_answer_len=8",
    "blip2.qformer.num_query_tokens=4", "blip2.qformer.hidden_size=64",
    "blip2.qformer.num_layers=2", "blip2.qformer.num_heads=4",
    "blip2.qformer.intermediate_size=128", "blip2.qformer.encoder_width=48",
    "blip2.qformer.scene_token_capacity=64", "blip2.pc_feat_dim=48",
    "blip2.max_txt_len=16", "train.bf16=false",
]


def blip2_cfgs(extra=()):
    """(reference Config, port Config) of the tiny 3D-LLM."""
    from situation3d_tpu.config import Config as JConfig, apply_overrides as japply
    from situation3d_tpu_torch.config import Config as TConfig, apply_overrides as tapply
    opts = [*BLIP2_TINY, *extra]
    return japply(JConfig(), opts), tapply(TConfig(), opts)


def blip2_batch(rng, bcfg, B=3, n_points=(64, 40, 23), n_prompt=(16, 9, 5), n_ans=(3, 8, 1)):
    """A training batch of the 3D-LLM as numpy arrays: scenes padded to the
    scene-token capacity, prompts and answers of several lengths."""
    N, L, La = bcfg.qformer.scene_token_capacity, bcfg.max_txt_len, bcfg.t5.max_answer_len
    V = bcfg.t5.vocab_size
    pc_mask = (np.arange(N)[None] < np.array(n_points[:B])[:, None]).astype(np.int32)
    in_mask = (np.arange(L)[None] < np.array(n_prompt[:B])[:, None]).astype(np.int32)
    l_mask = (np.arange(La)[None] < np.array(n_ans[:B])[:, None]).astype(np.int32)
    return {
        "pc_feat": (rng.randn(B, N, bcfg.pc_feat_dim) * pc_mask[..., None]).astype(np.float32),
        "pc": (rng.randint(-5, 300, (B, N, 3)) * pc_mask[..., None]).astype(np.int32),
        "pc_mask": pc_mask,
        "input_ids": (rng.randint(2, V, (B, L)) * in_mask).astype(np.int32),
        "input_mask": in_mask,
        "labels": np.where(l_mask > 0, rng.randint(2, V, (B, La)), -100).astype(np.int32),
        "label_mask": l_mask,
    }


def fake_t5_state_dict(c, orig_vocab, rng, prefix=""):
    """An HF-layout T5 state dict (``encoder.block.N.layer.0.SelfAttention.q
    .weight`` ...) of random float32 values, ``orig_vocab`` embedding rows."""
    d, inner, dff = c.d_model, c.d_kv * c.num_heads, c.d_ff
    sd = {"shared.weight": rng.randn(orig_vocab, d), "lm_head.weight": rng.randn(orig_vocab, d),
          "encoder.final_layer_norm.weight": rng.rand(d),
          "decoder.final_layer_norm.weight": rng.rand(d)}

    def attn(b, rel):
        for n in "qkv":
            sd[f"{b}.{n}.weight"] = rng.randn(inner, d)
        sd[f"{b}.o.weight"] = rng.randn(d, inner)
        if rel:
            sd[f"{b}.relative_attention_bias.weight"] = rng.randn(
                c.relative_attention_num_buckets, c.num_heads)

    def ff(b):
        for n in ("wi_0", "wi_1"):
            sd[f"{b}.DenseReluDense.{n}.weight"] = rng.randn(dff, d)
        sd[f"{b}.DenseReluDense.wo.weight"] = rng.randn(d, dff)
        sd[f"{b}.layer_norm.weight"] = rng.rand(d)

    for stack, n, layers in (("encoder", c.num_layers, ("SelfAttention",)),
                             ("decoder", c.num_decoder_layers,
                              ("SelfAttention", "EncDecAttention"))):
        for i in range(n):
            for j, kind in enumerate(layers):
                attn(f"{stack}.block.{i}.layer.{j}.{kind}", i == 0 and kind == "SelfAttention")
                sd[f"{stack}.block.{i}.layer.{j}.layer_norm.weight"] = rng.rand(d)
            ff(f"{stack}.block.{i}.layer.{len(layers)}")
    return {prefix + k: (v * 0.3).astype(np.float32) for k, v in sd.items()}


def fake_blip2_state_dict(bcfg, orig_vocab, rng):
    """A reference BLIP-2 training checkpoint's state dict (query tokens,
    ``Qformer.bert.*``, ``t5_proj``, ``t5_model.shared`` / ``lm_head``)."""
    q = bcfg.qformer
    H, I, W = q.hidden_size, q.intermediate_size, q.encoder_width
    sd = {"query_tokens": rng.randn(1, q.num_query_tokens, H),
          "Qformer.bert.embeddings.LayerNorm.weight": 1 + 0.1 * rng.randn(H),
          "Qformer.bert.embeddings.LayerNorm.bias": 0.1 * rng.randn(H),
          "t5_proj.weight": rng.randn(bcfg.t5.d_model, H) * 0.1,
          "t5_proj.bias": rng.randn(bcfg.t5.d_model) * 0.1,
          "t5_model.shared.weight": rng.randn(orig_vocab, bcfg.t5.d_model),
          "t5_model.lm_head.weight": rng.randn(orig_vocab, bcfg.t5.d_model) * 0.1}

    def dense(name, n_out, n_in):
        sd[f"{name}.weight"] = rng.randn(n_out, n_in) / np.sqrt(n_in)
        sd[f"{name}.bias"] = 0.1 * rng.randn(n_out)

    def norm(name, n):
        sd[f"{name}.weight"] = 1 + 0.1 * rng.randn(n)
        sd[f"{name}.bias"] = 0.1 * rng.randn(n)

    for i in range(q.num_layers):
        b = f"Qformer.bert.encoder.layer.{i}"
        for name, kvw in [("attention", H)] + (
                [("crossattention", W)] if i % q.cross_attention_freq == 0 else []):
            dense(f"{b}.{name}.self.query", H, H)
            dense(f"{b}.{name}.self.key", H, kvw)
            dense(f"{b}.{name}.self.value", H, kvw)
            dense(f"{b}.{name}.output.dense", H, H)
            norm(f"{b}.{name}.output.LayerNorm", H)
        dense(f"{b}.intermediate_query.dense", I, H)
        dense(f"{b}.output_query.dense", H, I)
        norm(f"{b}.output_query.LayerNorm", H)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}
