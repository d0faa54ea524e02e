"""The ported slice as a whole: the port's ``SIG3D`` forward against the
reference's on one synthetic batch, with the reference's weights carried
across by ``ckpt_compat/from_jax.py`` and the reference's own token-sampling
draws injected (reproduced from its ``sample`` key, see
``torch_port_util.jax_sample_draws``).

float32, atol 1e-3 on the scores: the two frameworks sum the same products in
another order through 21 sparse convs, a transformer layer and the MCAN
blocks, and use their own ``erf``/``exp``; observed differences are ~1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.models import sig3d as jsig
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.models import sig3d as tsig

from torch_port_util import (jax_sample_draws, randomize_variables, scene_batch,
                             t2n, tiny_cfgs, to_numpy_tree)

torch.set_num_threads(1)
ATOL = 1e-3
B = 2


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.RandomState(0)
    batch = scene_batch(rng, tcfg, B)
    jmodel = jsig.SIG3D(jcfg, num_answers=12)
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                               "sample": jax.random.PRNGKey(1)}, b, train=False), batch)
    variables = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.randn(*s.shape)
                               / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(np.float32)),
        shapes)
    variables = randomize_variables(variables, rng)
    key = jax.random.PRNGKey(2)
    with jax.default_matmul_precision("highest"):
        jout = jax.jit(lambda v, b, k: jmodel.apply(
            v, b, train=False, rngs={"sample": k}))(variables, batch, key)
    tmodel = tsig.SIG3D(tcfg, 12, device="cpu")
    unused = load_jax_variables(tmodel, to_numpy_tree(variables["params"]),
                                to_numpy_tree(variables["batch_stats"]))
    draws = jax_sample_draws(jmodel, variables, key, B, tcfg.sparse.capacities[-1],
                             tcfg.model.num_scene_tokens)
    with torch.no_grad():
        tout = tmodel(batch, sample_draws=draws)
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, jmodel=jmodel, variables=variables,
                key=key, jout=jout, tmodel=tmodel, tout=tout, unused=unused, draws=draws)


@pytest.mark.parametrize("name", ["answer_scores", "aux_scores",
                                  "auxiliary_task_loc_gt", "att_feat_ori",
                                  "pred_pos_likelihood", "pred_rotation",
                                  "satt", "qatt", "oatt"])
def test_slice_outputs_match_reference(setup, name):
    got, want = t2n(setup["tout"][name]), np.asarray(setup["jout"][name])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_slice_tokens_and_counters_match_reference(setup):
    """Sampled token positions are exact (same draws, same stable argsort);
    pooled features differ by summation order only; overflow counters equal
    (the batch overflows the coarse capacities on purpose)."""
    tout, jout = setup["tout"], setup["jout"]
    np.testing.assert_array_equal(t2n(tout["scene_positions"]),
                                  np.asarray(jout["scene_positions"]))
    np.testing.assert_allclose(t2n(tout["att_feat_pre"]),
                               np.asarray(jout["att_feat_pre"]), atol=1e-5, rtol=0)
    for k in ("overflow/voxels_dropped", "overflow/extent_misses"):
        assert int(tout[k]) == int(jout[k])
    assert int(tout["overflow/voxels_dropped"]) > 0
    assert tout["answer_scores"].shape == (B, 12)
    assert tout["answer_scores"].dtype == torch.float32


@pytest.mark.parametrize("n_valid", [32, 5, 0])
def test_situated_token_pool_with_reference_draws(n_valid):
    """More columns than tokens, fewer (random duplicates pad), and none."""
    r = np.random.RandomState(n_valid)
    V, C, N, stride = 32, 6, 8, 16
    cells = np.unique(r.randint(0, 5, (200, 3)), axis=0)
    r.shuffle(cells)
    coords = np.zeros((B, V, 3), np.int32)
    coords[:] = (cells[:V] * stride)[None]
    mask = np.zeros((B, V), bool)
    mask[:, :n_valid] = True
    feats = r.randn(B, V, C).astype(np.float32) * mask[..., None]
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    want_f, want_p = jax.vmap(lambda c, f, m, k: jsig.situated_token_pool(
        c, f, m, stride, N, 0.02, k))(jnp.asarray(coords), jnp.asarray(feats),
                                      jnp.asarray(mask), keys)
    us, dups = [], []
    for k in keys:
        r1, r2 = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(r1, (V,))))
        dups.append(np.asarray(jax.random.randint(r2, (N,), 0, jnp.iinfo(jnp.int32).max)))
    got_f, got_p = tsig.situated_token_pool(
        torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(mask),
        stride, N, 0.02, torch.from_numpy(np.stack(us)),
        torch.from_numpy(np.stack(dups).astype(np.int32)))
    np.testing.assert_array_equal(t2n(got_p), np.asarray(want_p))
    np.testing.assert_allclose(t2n(got_f), np.asarray(want_f), atol=1e-5, rtol=0)


def test_scene_tokens_fast_path_and_situated_reencode(setup):
    """The serving fast path with ``model.situated_reencode`` on (token
    positions rotated into the agent's frame), a non-trivial heading."""
    jcfg, tcfg = tiny_cfgs(("model.situated_reencode=true",))
    batch = {k: v for k, v in setup["batch"].items() if not k.startswith("voxel_")}
    batch["auxiliary_task"] = batch["auxiliary_task"].copy()
    batch["auxiliary_task"][:, 3:] = [[0, 0, 0.6, 0.8], [0, 0, -0.8, -0.6]]
    batch["scene_tokens"] = np.array(setup["jout"]["att_feat_pre"])
    batch["scene_token_positions"] = np.array(setup["jout"]["scene_positions"])
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, b: jsig.SIG3D(jcfg, num_answers=12).apply(
            v, b, train=False))({"params": setup["variables"]["params"]}, batch)
    model = tsig.SIG3D(tcfg, 12, device="cpu")
    model.load_state_dict(setup["tmodel"].state_dict())
    with torch.no_grad():
        got = model(batch)
    assert "overflow/voxels_dropped" not in got
    for k in ("answer_scores", "aux_scores", "auxiliary_task_loc_gt"):
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), atol=ATOL, rtol=0)
    with torch.no_grad():
        plain = setup["tmodel"](batch)["answer_scores"]
    assert float((plain - got["answer_scores"]).abs().max()) > 1e-4


def test_forward_draws_from_a_generator(setup):
    """Without injected draws the forward samples from a ``torch.Generator``:
    same seed, same tokens; the draws have the documented ranges."""
    m, batch = setup["tmodel"], setup["batch"]
    with torch.no_grad():
        a = m(batch, generator=torch.Generator().manual_seed(3))
        b = m(batch, generator=torch.Generator().manual_seed(3))
        c = m(batch, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a["scene_positions"], b["scene_positions"])
    assert torch.equal(a["answer_scores"], b["answer_scores"])
    assert not torch.equal(a["scene_positions"], c["scene_positions"])
    u, dup = tsig.make_sample_draws(2, 32, 8, torch.Generator().manual_seed(0))
    assert u.dtype == torch.float32 and dup.dtype == torch.int32
    assert float(u.min()) >= 0 and float(u.max()) < 1 and int(dup.min()) >= 0


@pytest.mark.parametrize("tag,dim", [("__l2__quat__", 4), ("__class__angle__", 2),
                                     ("__l2__6d__", 6)])
def test_rotation_dim(tag, dim):
    assert tsig.rotation_dim(tag) == jsig.rotation_dim(tag) == dim
    with pytest.raises(ValueError):
        tsig.rotation_dim("__l2__")


def test_converter_reports_the_decoder_and_nothing_else(setup):
    unused = setup["unused"]
    assert unused == sorted(unused) and len(unused) == len(set(unused))
    assert all(u.split("/")[1] == "scene_encoder" for u in unused)
    assert {u.split("/")[2] for u in unused} == {
        "convtr4p16s2", "bntr4", "block5", "convtr5p8s2", "bntr5", "block6"}
    n_ref = sum(1 for _ in jax.tree_util.tree_leaves(setup["variables"]))
    n_port = len(setup["tmodel"].state_dict())
    assert n_ref == n_port + len(unused)


def test_converter_raises_on_missing_leaf_and_shape_mismatch(setup):
    params = to_numpy_tree(setup["variables"]["params"])
    stats = to_numpy_tree(setup["variables"]["batch_stats"])
    model = tsig.SIG3D(setup["tcfg"], 12, device="cpu")
    broken = {**params, "enc_s0": {k: v for k, v in params["enc_s0"].items()
                                   if k != "norm1"}}
    with pytest.raises(KeyError, match="enc_s0/norm1"):
        load_jax_variables(model, broken, stats)
    with pytest.raises(KeyError, match="batch_stats/scene_encoder/bn0/mean"):
        load_jax_variables(model, params, {})
    bad = {**params, "answer_cls_fc2": {
        "kernel": params["answer_cls_fc2"]["kernel"][:, :5],
        "bias": params["answer_cls_fc2"]["bias"]}}
    with pytest.raises(ValueError, match="answer_cls_fc2.weight"):
        load_jax_variables(model, bad, stats)
    # a port with a module the reference tree lacks: its tensors stay unfilled
    model.extra = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="extra.weight"):
        load_jax_variables(model, params, stats)
