"""The port's data-parallel layer (``parallel/collectives.py``,
``parallel/mesh.py``) at world 2 on the CPU (gloo, two spawned processes,
``tests/torch_ddp_worker.py``), held against the JAX package's collectives
run under ``shard_map`` over two of the 8 virtual CPU devices.

One spawn for the module: the ranks run every check at once while this
process computes the references, and the tests read the ranks' results.

- ``pmean`` / ``psum`` / ``pmin``, the stacked and tiled ``all_gather`` and
  ``ppermute_ring`` equal JAX's (float32 sums of two values: exact up to one
  rounding, rtol 1e-6); the gradient of a function of the tiled gather (the
  backward is JAX's reduce-scatter VJP) within 1e-5;
- ``itc_loss(axis="data")`` averaged over the ranks equals JAX's
  ``shard_map`` form, and the ranks' feature gradients over the world equal
  the global batch's ``itc_loss`` gradient (1e-5);
- ``shard_batch`` keeps each rank's contiguous rows; ``make_mesh`` raises on
  ``data_parallel`` other than -1 or the world, and on ``model_parallel`` 2;
- ``SmoothedValue`` / ``MetricLogger.synchronize_between_processes`` equal
  one process that saw every value;
- retrieval at world 2: the ranks' score matrices summed equal the JAX
  package's per-rank matrices summed (its merge contract, scores within 1e-5
  of the largest), and recall equals the one-process evaluation;
- a training-form ``SparseBatchNorm`` at world 2 (the ranks hold different
  numbers of valid voxels) takes the statistics of the whole batch, as the
  reference's ``SparseBatchNorm`` on the global batch: outputs and running
  statistics within 1e-6, the ranks' feature gradients and their summed
  parameter gradients within 1e-5 of ``jax.grad`` of the global loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_ddp_worker as W
from situation3d_tpu.config import MeshConfig as JMeshConfig
from situation3d_tpu.eval import retrieval as jret
from situation3d_tpu.models import blip2_qformer as jq
from situation3d_tpu.parallel import collectives as jc
from situation3d_tpu.parallel.mesh import make_mesh as jmake_mesh
from situation3d_tpu.train.contrastive import itc_loss as jitc
from situation3d_tpu_torch.config import MeshConfig
from situation3d_tpu_torch.models import blip2_qformer as tq
from situation3d_tpu_torch.parallel import (batch_sharding, make_mesh, replicated,
                                            shard_batch)
from situation3d_tpu_torch.train import tasks as ttasks
from situation3d_tpu_torch.train.logging import MetricLogger, SmoothedValue
from test_torch_batchnorm_train import _bn_case, jax_batchnorm_step
from torch_port_util import BLIP2_TINY, blip2_cfgs, load_into_port, random_variables_of

torch.set_num_threads(1)
WORLD = 2
RTOL = 1e-6           # a sum of two float32 values
GRAD_RTOL = 1e-5
STAGE1 = ["blip2.qformer.vocab_size=96", "blip2.qformer.max_position=40", "train.bf16=false"]
K_TEST = 3


def _retrieval_payload(rng):
    """A tiny stage-1 Q-Former with seeded weights in both packages, 6
    scenes x 6 captions."""
    jcfg, tcfg = blip2_cfgs(STAGE1)
    qcfg = jcfg.blip2.qformer
    n, N, L = 6, qcfg.scene_token_capacity, 9
    im = (np.arange(N)[None] < rng.randint(10, N + 1, (n, 1))).astype(np.int32)
    tm = (np.arange(L)[None] < rng.randint(2, L + 1, (n, 1))).astype(np.int32)
    args = ((rng.randn(n, N, qcfg.encoder_width) * im[..., None]).astype(np.float32), im,
            (rng.randint(4, qcfg.vocab_size - 2, (n, L)) * tm).astype(np.int32), tm)
    jm = jq.Blip2Qformer(qcfg)
    jb = dict(zip(("image_embeds", "image_mask", "text_ids", "text_mask"),
                  map(jnp.asarray, args)))
    v = random_variables_of(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "sample": jax.random.PRNGKey(1)}, jb), rng)
    variables = {"params": {**v["params"], "temp": jnp.asarray(np.float32(0.1))}}
    tm_ = load_into_port(tq.Blip2Qformer(tcfg.blip2.qformer, device="cpu"), variables)
    pairs = ([[i, (i + 2) % n] for i in range(n)], list(range(n)))
    payload = {"options": [*BLIP2_TINY, *STAGE1], "state": tm_.state_dict(), "args": args,
               "k_test": K_TEST, "pairs": pairs}
    return payload, jm, variables, tm_, tcfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.RandomState(0)
    retrieval, jm, variables, tm_, tcfg = _retrieval_payload(rng)
    p = {"x": rng.randn(WORLD, 3, 4).astype(np.float32),
         "w": rng.randn(WORLD, WORLD * 3, 4).astype(np.float32),
         "img": rng.randn(6, 3, 8).astype(np.float32),
         "txt": rng.randn(6, 8).astype(np.float32), "temp": np.float32(0.1),
         "batch": {"a": np.arange(12).reshape(6, 2), "b": rng.rand(6, 3, 2)},
         "values": [[(1.0, 1), (2.5, 2), (4.0, 1)], [(7.0, 3), (-1.0, 1)]],
         "retrieval": retrieval}
    feats, mask, bn_vars, R = _bn_case(5, B=4, V=30, C=6)
    mask[:2, 20:] = False                 # the ranks hold different valid counts
    p["batchnorm"] = {"feats": feats, "mask": mask, "R": R, "momentum": 0.8,
                      "state": {**bn_vars["params"], **bn_vars["batch_stats"]}}
    started = W.start("parallel", p, tmp_path_factory.mktemp("parallel"))

    # the references, while the ranks run
    mesh = jmake_mesh(JMeshConfig(data_parallel=WORLD))
    sm = lambda f, i, o: jax.jit(shard_map(f, mesh=mesh, in_specs=i, out_specs=o,  # noqa: E731
                                           check_vma=False))
    X = jnp.asarray(p["x"].reshape(WORLD * 3, 4))
    ref = {
        "pmean": sm(lambda x: jc.pmean(x, "data"), P("data"), P())(X),
        "psum": sm(lambda x: jc.psum(x, "data"), P("data"), P())(X),
        "pmin": sm(lambda x: jax.lax.pmin(x, "data"), P("data"), P())(X),
        "gather": sm(lambda x: jc.all_gather(x, "data"), P("data"), P())(X),
        "gather_tiled": sm(lambda x: jc.all_gather(x, "data", tiled=True), P("data"), P())(X),
        "ring": sm(lambda x: jc.ppermute_ring(x, "data"), P("data"), P("data"))(X),
        "ring_back": sm(lambda x: jc.ppermute_ring(x, "data", shift=-1), P("data"),
                        P("data"))(X),
    }
    F = sm(lambda x, w: jc.psum(jnp.sum(w * jc.all_gather(x, "data", tiled=True) ** 2), "data"),
           (P("data"), P("data")), P())
    ref["gather_grad"] = jax.grad(F)(X, jnp.asarray(p["w"].reshape(-1, 4)))
    temp = jnp.asarray(p["temp"])
    with jax.default_matmul_precision("highest"):
        ref["itc"] = sm(lambda i, t: jc.pmean(jitc(i, t, temp, axis="data"), "data"),
                        (P("data"), P("data")), P())(jnp.asarray(p["img"]),
                                                     jnp.asarray(p["txt"]))
        ref["itc_grads"] = jax.grad(lambda i, t: jitc(i, t, temp), argnums=(0, 1))(
            jnp.asarray(p["img"]), jnp.asarray(p["txt"]))
        parts = [jret.compute_sim_matrix(jm, variables, *retrieval["args"], k_test=K_TEST,
                                         encode_batch=4, rerank_chunk=3, rank=r, world=WORLD)
                 for r in range(WORLD)]
    ref = {k: (np.asarray(v) if not isinstance(v, tuple) else tuple(map(np.asarray, v)))
           for k, v in ref.items()}
    ref["merged"] = [parts[0][i] + parts[1][i] for i in range(2)]
    task = ttasks.RetrievalTask(tcfg, k_test=K_TEST, device="cpu")
    ref["recall"] = task.evaluation(tm_, *retrieval["args"], *retrieval["pairs"])
    ref["batchnorm"] = jax_batchnorm_step(feats, mask, bn_vars, R, 0.8)
    return p, ref, W.finish(started)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30), \
        np.abs(got - want).max()


@pytest.mark.parametrize("name", ["pmean", "psum", "pmin", "gather", "gather_tiled"])
def test_reductions_and_gathers_equal_jax(run, name):
    _, ref, ranks = run
    for res in ranks:                       # every rank holds the same value
        _close(res[name], ref[name], RTOL)


@pytest.mark.parametrize("name", ["ring", "ring_back"])
def test_ppermute_ring_equals_jax(run, name):
    _, ref, ranks = run
    _close(np.concatenate([r[name] for r in ranks]), ref[name], 0.0)


def test_all_gather_gradient_is_jax_reduce_scatter(run):
    _, ref, ranks = run
    _close(np.concatenate([r["gather_grad"] for r in ranks]), ref["gather_grad"], GRAD_RTOL)


def test_itc_loss_gathers_negatives_as_jax(run):
    """The ranks' mean equals JAX's ``shard_map`` form; each rank's feature
    gradients, over the world, equal the global batch's ``itc_loss``
    gradient (averaging the ranks' parameter gradients then gives the
    global step)."""
    _, ref, ranks = run
    _close(np.mean([r["itc"] for r in ranks]), ref["itc"], GRAD_RTOL)
    for i in range(2):
        got = np.concatenate([r["itc_grads"][i] for r in ranks]) / WORLD
        _close(got, ref["itc_grads"][i], GRAD_RTOL)


def test_shard_batch_keeps_contiguous_rows(run):
    p, _, ranks = run
    for r, res in enumerate(ranks):
        assert res["mesh"] == (WORLD, r, "cpu")
        for k, v in p["batch"].items():
            np.testing.assert_array_equal(res["shard"][k], v[3 * r: 3 * (r + 1)])
        assert "does not split over 2" in res["odd_batch"]
    assert ranks[0]["host"] == [{"rank": 0}, {"rank": 1}]


def test_make_mesh_errors(run):
    _, _, ranks = run
    for res in ranks:
        assert res["dp_world"] == WORLD
        kind, msg = res["mesh_errors"]["dp3"]
        assert kind == "ValueError" and "data_parallel=3" in msg and "2 process" in msg
        assert res["mesh_errors"]["mp2"][0] == "NotImplementedError"
    # one process, no process group
    assert make_mesh(MeshConfig(), "cpu").world == 1
    assert make_mesh(MeshConfig(data_parallel=1), "cpu").rank == 0
    with pytest.raises(ValueError, match="data_parallel=2"):
        make_mesh(MeshConfig(data_parallel=2), "cpu")
    with pytest.raises(NotImplementedError, match="model_parallel=2"):
        make_mesh(MeshConfig(model_parallel=2), "cpu")
    one = make_mesh(MeshConfig(), "cpu")
    batch = {"a": np.arange(3)}
    assert shard_batch(batch, one) is batch and batch_sharding(one, 3) == slice(0, 3)
    lin = torch.nn.Linear(2, 2)
    assert replicated(lin, one) is lin


def test_metric_sync_equals_one_process(run):
    p, _, ranks = run
    sv, ml = SmoothedValue(window_size=3), MetricLogger(window_size=3)
    for r in range(WORLD):
        for v, n in p["values"][r]:
            sv.update(v, n)
            ml.update(loss=v, acc=v / 2)
    for res in ranks:
        count, total, gavg = res["smoothed"][:3]
        assert (count, total) == (sv.count, sv.total) and gavg == pytest.approx(sv.global_avg)
        assert res["logger"] == pytest.approx(ml.global_avg())
    # the window stays each rank's own
    assert ranks[1]["smoothed"][4] == -1.0 and ranks[0]["smoothed"][4] == 4.0


def test_retrieval_merges_ranks_by_a_sum(run):
    _, ref, ranks = run
    for res in ranks:
        for got, want in zip(res["retrieval"]["merged"], ref["merged"]):
            fill = want == 2 * jret.FILL                  # no rank reranked the entry
            np.testing.assert_array_equal(got == 2 * jret.FILL, fill)
            scores = want[~fill] - jret.FILL
            atol = 1e-5 * np.abs(scores).max() + 2 * np.spacing(np.float32(-2 * jret.FILL))
            assert np.abs(got[~fill] - want[~fill]).max() <= atol
    assert ranks[0]["retrieval"]["metrics"] == ref["recall"]
    assert ranks[1]["retrieval"]["metrics"] == {}


def test_batchnorm_takes_the_statistics_of_the_whole_batch(run):
    _, ref, ranks = run
    out, stats, gf, gp = ref["batchnorm"]
    got = [r["batchnorm"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]), out, atol=1e-6)
    for g in got:
        for k in ("mean", "var"):
            np.testing.assert_allclose(g[k], stats[k], atol=1e-6)
    np.testing.assert_allclose(np.concatenate([g["feats_grad"] for g in got]), gf, atol=1e-5)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(sum(g[f"{k}_grad"] for g in got), gp[k], atol=1e-5)
