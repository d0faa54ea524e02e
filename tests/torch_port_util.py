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
            if coll == "params":
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


def random_variables(jmodel, batch, rng):
    """Reference variables for ``jmodel`` without running its initializers:
    shapes from ``jax.eval_shape``, values from numpy (fan-in scaled), then
    ``randomize_variables``."""
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                               "sample": jax.random.PRNGKey(1)}, b, train=False), batch)
    variables = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.randn(*s.shape)
                               / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(np.float32)),
        shapes)
    return randomize_variables(variables, rng)
