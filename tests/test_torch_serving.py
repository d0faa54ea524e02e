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
from situation3d_tpu_torch.models import sig3d as tsig
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


def _capture_on_the_cpu(step, steps, device):
    """``capture_steps`` without a card: the step's first outputs stand for
    the graph's static outputs, and a replay runs the step again and writes
    its outputs into them, as a replayed graph does."""
    (i,) = steps
    out = step(i, False)

    class Replayed:
        def replay(self):
            for k, v in step(i, False).items():
                if k not in tsig.CALLER_OUTPUTS:
                    out[k].copy_(v)
    return [Replayed()], [out]


def test_replayed_outputs_survive_the_next_call(monkeypatch):
    """The captured path's copy-in, replay and clones, with the capture
    stood in for on the CPU: a first batch's outputs survive the next
    replay of its key; every output equals the eager forward's; one capture
    a key (``SceneCache``'s one token row, then a full forward's), one
    replay a call."""
    monkeypatch.setattr(tsig, "question_graph_captures", 0)
    monkeypatch.setattr(tsig, "question_graph_replays", 0)
    _, cfg = tiny_cfgs()
    rng = np.random.RandomState(2)
    model = SIG3D(cfg, 12, device="cpu")
    init_random_weights(model, 0)
    scene = scene_batch(rng, cfg, 1)
    cache = SceneCache(model, device="cpu")
    cache.encode("s", scene, generator=torch.Generator().manual_seed(3))
    qs = [_questions(rng, cfg, scene) for _ in range(2)]
    full = {**qs[0], **{k: np.repeat(v, N_Q, 0) for k, v in scene.items()
                        if k.startswith("voxel_")}}
    draws = tsig.make_sample_draws(N_Q, cfg.sparse.capacities[-1], cfg.model.num_scene_tokens,
                                   torch.Generator().manual_seed(4))
    with torch.no_grad():
        eager = [cache.answer("s", q) for q in qs] + [model(full, sample_draws=draws)]
    monkeypatch.setattr(tsig, "eager", lambda device: False)
    monkeypatch.setattr(tsig, "capture_steps", _capture_on_the_cpu)
    with torch.no_grad():
        first = cache.answer("s", qs[0])
        kept = {k: v.clone() for k, v in first.items()}
        second = cache.answer("s", qs[1])
        assert (tsig.question_graph_captures, tsig.question_graph_replays) == (1, 2)
        ((inputs, _, _),) = model.question_graphs.keys
        shapes = {name: shape for name, shape, _ in inputs}
        assert shapes["scene_tokens"][0] == 1 and shapes["s_ids"][0] == N_Q
        replayed = [first, second, model(full, sample_draws=draws)]
    assert (tsig.question_graph_captures, tsig.question_graph_replays) == (2, 3)
    assert len(model.question_graphs.keys) == 2
    assert not torch.equal(first["answer_scores"], second["answer_scores"])
    for k in kept:
        assert torch.equal(first[k], kept[k]), k
    for got, want in zip(replayed, eager):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert first["scene_positions"].data_ptr() == cache._cache["s"][1].data_ptr()
