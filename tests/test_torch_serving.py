"""Scene-cache serving of the port: answers against one cached scene equal
the full forward's given the same tokens (exact on the CPU), and equal the
reference's ``SceneCache`` (float32, atol 1e-3: summation order through the
whole model, as in ``test_torch_sig3d.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.eval.serving import SceneCache as JSceneCache
from situation3d_tpu.models.sig3d import SIG3D as JSIG3D
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.eval.serving import SceneCache
from situation3d_tpu_torch.models.sig3d import SIG3D, init_random_weights

from torch_port_util import (jax_sample_draws, randomize_variables, scene_batch,
                             t2n, tiny_cfgs, to_numpy_tree)

torch.set_num_threads(1)
N_Q = 3


def _questions(rng, cfg, scene):
    """N_Q questions about one scene: its situation text, fresh questions."""
    q = scene_batch(rng, cfg, N_Q)
    return {"s_ids": np.repeat(scene["s_ids"], N_Q, 0),
            "s_mask": np.repeat(scene["s_mask"], N_Q, 0),
            "q_ids": q["q_ids"], "q_mask": q["q_mask"],
            "auxiliary_task": np.repeat(scene["auxiliary_task"], N_Q, 0)}


def test_cache_answer_equals_full_forward():
    _, cfg = tiny_cfgs()
    rng = np.random.RandomState(0)
    model = SIG3D(cfg, 12, device="cpu")
    init_random_weights(model, 0)
    scenes = [scene_batch(rng, cfg, 1) for _ in range(2)]
    cache = SceneCache(model, device="cpu")
    assert "scene0" not in cache
    for i, scene in enumerate(scenes):
        gen = torch.Generator().manual_seed(10 + i)
        cache.encode(f"scene{i}", scene, generator=gen)
        assert f"scene{i}" in cache
        q = _questions(rng, cfg, scene)
        out = cache.answer(f"scene{i}", q)
        assert out["answer_scores"].shape == (N_Q, 12)
        voxels = {k: np.repeat(v, N_Q, 0) for k, v in scene.items()
                  if k.startswith("voxel_")}
        for j in range(N_Q):
            one = {k: v[j:j + 1] for k, v in {**q, **voxels}.items()}
            with torch.no_grad():
                full = model(one, generator=torch.Generator().manual_seed(10 + i))
            np.testing.assert_allclose(t2n(out["answer_scores"][j]),
                                       t2n(full["answer_scores"][0]),
                                       atol=2e-6, rtol=0)
            assert torch.equal(out["scene_positions"][j], full["scene_positions"][0])
    # a scene already cached is not encoded again
    before = cache._cache["scene0"][0].clone()
    cache.encode("scene0", scenes[1])
    assert torch.equal(cache._cache["scene0"][0], before)
    with pytest.raises(KeyError):
        cache.answer("nope", q)


def test_cache_matches_reference_scene_cache():
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.RandomState(1)
    scene = scene_batch(rng, tcfg, 1)
    q = _questions(rng, tcfg, scene)
    jmodel = JSIG3D(jcfg, num_answers=12)
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                               "sample": jax.random.PRNGKey(1)}, b, train=False), scene)
    variables = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.randn(*s.shape)
                               / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(np.float32)),
        shapes)
    variables = randomize_variables(variables, rng)
    key = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        jcache = JSceneCache(jmodel, variables)
        jcache.encode("s", scene, key)
        want = jcache.answer("s", q, key)
    model = SIG3D(tcfg, 12, device="cpu")
    load_jax_variables(model, to_numpy_tree(variables["params"]),
                       to_numpy_tree(variables["batch_stats"]))
    draws = jax_sample_draws(jmodel, variables, key, 1, tcfg.sparse.capacities[-1],
                             tcfg.model.num_scene_tokens)
    cache = SceneCache(model, device="cpu")
    cache.encode("s", scene, sample_draws=draws)
    got = cache.answer("s", q)
    np.testing.assert_array_equal(t2n(got["scene_positions"]),
                                  np.asarray(want["scene_positions"]))
    for k in ("answer_scores", "aux_scores"):
        assert float(np.abs(np.asarray(want[k])).max()) > 1e-3
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), atol=1e-3, rtol=0)
