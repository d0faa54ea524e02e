"""Reference-format checkpoints of SIG3D's encoders in the port
(``ckpt_compat/minkunet.py``, ``ckpt_compat/mpnet.py``,
``ckpt_compat/common.py:strip_prefix``) against the reference's converters on
seeded state dicts: the trees bit-equal, MinkowskiEngine's offset order
equal; and a tiny SIG3D whose scene and language encoders come from such
state dicts through the port's converters and ``load_jax_variables``: answer
scores within 1e-5 of the reference's SIG3D with its own converters' trees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ckpt_compat import common as jcommon
from situation3d_tpu.ckpt_compat import minkunet as jmink
from situation3d_tpu.ckpt_compat import mpnet as jmpnet
from situation3d_tpu.models import sig3d as jsig
from situation3d_tpu_torch.ckpt_compat import common as tcommon
from situation3d_tpu_torch.ckpt_compat import minkunet as tmink
from situation3d_tpu_torch.ckpt_compat import mpnet as tmpnet
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.models import sig3d as tsig
from situation3d_tpu_torch.sparse.minkunet import build_unet_plan

from torch_port_util import (fake_mpnet_state_dict, jax_sample_draws, random_variables,
                             scene_batch, t2n, tiny_cfgs, to_numpy_tree)

torch.set_num_threads(1)
ATOL = 1e-5


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_strip_prefix_equals_reference():
    sd = {"module.a": np.ones(2), "module.b.c": np.zeros(3), "other": np.ones(1),
          "x.module.d": np.ones(1)}
    for prefix in ("module.", "x.", "none."):
        got, want = tcommon.strip_prefix(sd, prefix), jcommon.strip_prefix(sd, prefix)
        assert list(got) == list(want)
        assert_trees_equal(got, want)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_me_offset_order_equals_reference(k):
    rng = np.random.RandomState(k)
    np.testing.assert_array_equal(tmink.me_offset_permutation(k),
                                  jmink.me_offset_permutation(k))
    kern = rng.randn(k ** 3, 4, 6).astype(np.float32)
    for x_fastest in (True, False):
        np.testing.assert_array_equal(tmink.reorder_kernel(kern, k, x_fastest),
                                      jmink.reorder_kernel(kern, k, x_fastest))
    assert tmink.kernel_order_coherence(kern, k) == jmink.kernel_order_coherence(kern, k)
    with pytest.raises(ValueError, match="not a 4-cube"):
        tmink.reorder_kernel(kern, 4)


@pytest.mark.parametrize("final_result,prefix", [(True, ""), (False, "module.")])
def test_convert_minkunet_equals_reference(final_result, prefix):
    _, tcfg = tiny_cfgs(("sparse.layers=2,1,1,2,1,1,2,1",))
    sd = tmink.random_reference_state_dict(tcfg.sparse, np.random.RandomState(1))
    sd = {prefix + k: v for k, v in sd.items()}
    layers = tcfg.sparse.layers
    got = tmink.convert_minkunet(sd, layers, final_result=final_result)
    want = jmink.convert_minkunet(sd, layers, final_result=final_result)
    for g, w in zip(got, want):
        assert_trees_equal(g, w)
    assert ("final" in got[0]) == final_result and "downsample_conv" in got[0]["block2"]["block0"]


@pytest.mark.parametrize("prefix", ["", "mpnet.", "0.auto_model."])
def test_convert_mpnet_equals_reference(prefix):
    _, tcfg = tiny_cfgs()
    sd = fake_mpnet_state_dict(tcfg.lang, np.random.RandomState(2), prefix)
    sd["pooler.dense.weight"] = np.ones((2, 2), np.float32)      # not the encoder's
    assert_trees_equal(tmpnet.convert_mpnet(sd, tcfg.lang.num_layers),
                       jmpnet.convert_mpnet(sd, tcfg.lang.num_layers))


def test_sig3d_from_reference_checkpoints():
    """The scene encoder from a MinkowskiEngine state dict (``module.``
    prefixed, as a DataParallel save is) and the language encoder from an
    HF MPNet one (``mpnet.`` prefixed); the rest of the model seeded. The
    reference runs on the port's plan (bit-equal to its own,
    ``tests/test_torch_kernel_map.py``) with its own token draws."""
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.RandomState(3)
    B = 2
    batch = scene_batch(rng, tcfg, B)
    jmodel = jsig.SIG3D(jcfg, num_answers=12)
    variables = to_numpy_tree(random_variables(jmodel, batch, rng))
    unet_sd = {"module." + k: v for k, v in
               tmink.random_reference_state_dict(tcfg.sparse, rng).items()}
    mpnet_sd = fake_mpnet_state_dict(tcfg.lang, rng, "mpnet.")

    def with_encoders(params, stats, unet, mpnet):
        params = {**params, "scene_encoder": unet[0],
                  "lang_net": {**params["lang_net"], "encoder": mpnet}}
        return params, {**stats, "scene_encoder": unet[1]}

    sp, L = tcfg.sparse, tcfg.lang.num_layers
    jparams, jstats = with_encoders(variables["params"], variables["batch_stats"],
                                    jmink.convert_minkunet(unet_sd, sp.layers, False),
                                    jmpnet.convert_mpnet(mpnet_sd, L))
    tparams, tstats = with_encoders(variables["params"], variables["batch_stats"],
                                    tmink.convert_minkunet(unet_sd, sp.layers, False),
                                    tmpnet.convert_mpnet(mpnet_sd, L))
    plan = build_unet_plan(batch["voxel_coords"], batch["voxel_mask"], sp.capacities,
                           sp.grid_extent, device="cpu")
    jv = jax.tree_util.tree_map(jnp.asarray, {"params": jparams, "batch_stats": jstats})
    key = jax.random.PRNGKey(4)
    jbatch = {**batch, "plan": jax.tree_util.tree_map(lambda t: jnp.asarray(t2n(t)), plan)}
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, b, k: jmodel.apply(v, b, train=False, rngs={"sample": k}))(
            jv, jbatch, key)
    tmodel = tsig.SIG3D(tcfg, 12, device="cpu")
    assert load_jax_variables(tmodel, tparams, tstats) == []
    draws = jax_sample_draws(jmodel, jv, key, B, sp.capacities[-1],
                             tcfg.model.num_scene_tokens)
    with torch.no_grad():
        got = tmodel({**batch, "plan": plan}, sample_draws=draws)
    for k in ("answer_scores", "aux_scores", "att_feat_pre"):
        w = np.asarray(want[k])
        assert float(np.abs(w).max()) > 1e-3, k
        np.testing.assert_allclose(t2n(got[k]), w, atol=ATOL, rtol=0, err_msg=k)
