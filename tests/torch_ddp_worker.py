"""Rank functions of the two-process CPU tests of the port's data
parallelism (``tests/test_torch_parallel.py``, ``tests/test_torch_ddp_step.py``).

This module imports torch and the port only: ``start`` runs each rank in a
fresh interpreter that imports it by name, so a rank never pays for JAX.
Each job takes ``(rank, world, payload)`` inside a gloo process group and
returns a picklable result; ``finish`` hands the parent every rank's result,
and the parent computes its references while the ranks run.
"""
import os
import pickle
import socket
import traceback

import numpy as np
import torch

from situation3d_tpu_torch.config import Config, MeshConfig, apply_overrides
from situation3d_tpu_torch.parallel import collectives as C
from situation3d_tpu_torch.parallel.mesh import make_mesh, shard_batch

SPAWN_TIMEOUT = 240     # seconds for the ranks of one spawn to finish


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, job, payload, out_dir):
    try:
        torch.set_num_threads(1)
        C.initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                               device="cpu")
        try:
            result = JOBS[job](rank, world, payload)
        finally:
            torch.distributed.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def start(job: str, payload, out_dir, world: int = 2):
    """Start ``JOBS[job]`` on ``world`` ranks (gloo over a free local port)
    and return at once; ``finish`` collects the results."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, job, payload, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, str(out_dir)


def finish(started) -> list:
    """Every rank's result, in rank order. A rank that fails or does not end
    within ``SPAWN_TIMEOUT`` fails the call, with its traceback."""
    procs, out_dir = started
    for p in procs:
        p.join(SPAWN_TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(out_dir, f"{r}.err")).read() for r in range(len(procs))
              if os.path.exists(os.path.join(out_dir, f"{r}.err"))]
    codes = [p.exitcode for p in procs]
    assert not errors and codes == [0] * len(procs), (codes, errors)
    results = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _rows(x, rank, world):
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


# ---------------------------------------------------------------------------
# collectives, the mesh, the contrastive loss, metric sync, retrieval

def parallel_job(rank, world, p):
    from situation3d_tpu_torch.train.contrastive import itc_loss
    from situation3d_tpu_torch.train.logging import MetricLogger, SmoothedValue
    out = {}
    x = torch.from_numpy(p["x"][rank])
    out["pmean"], out["psum"] = C.pmean(x).numpy(), C.psum(x).numpy()
    out["pmin"] = C.pmin(x).numpy()
    out["gather"] = C.all_gather(x).numpy()
    out["gather_tiled"] = C.all_gather(x, tiled=True).numpy()
    out["ring"] = C.ppermute_ring(x).numpy()
    out["ring_back"] = C.ppermute_ring(x, shift=-1).numpy()
    xg = x.clone().requires_grad_(True)
    f = (torch.from_numpy(p["w"][rank]) * C.all_gather(xg, tiled=True) ** 2).sum()
    f.backward()
    out["gather_grad"] = xg.grad.numpy()
    out["host"] = C.process_gather_host({"rank": rank})

    img = torch.from_numpy(_rows(p["img"], rank, world)).requires_grad_(True)
    txt = torch.from_numpy(_rows(p["txt"], rank, world)).requires_grad_(True)
    loss = itc_loss(img, txt, torch.tensor(p["temp"]), axis="data")
    loss.backward()
    out["itc"], out["itc_grads"] = float(loss), (img.grad.numpy(), txt.grad.numpy())

    mesh = make_mesh(MeshConfig(), "cpu")
    out["mesh"] = (mesh.world, mesh.rank, str(mesh.device))
    out["shard"] = {k: v.numpy() for k, v in shard_batch(p["batch"], mesh).items()}
    errors = {}
    for name, cfg in (("dp3", MeshConfig(data_parallel=3)), ("mp2", MeshConfig(model_parallel=2))):
        try:
            make_mesh(cfg, "cpu")
        except (ValueError, NotImplementedError) as e:
            errors[name] = (type(e).__name__, str(e))
    out["mesh_errors"] = errors
    out["dp_world"] = make_mesh(MeshConfig(data_parallel=world), "cpu").world
    try:
        shard_batch({"a": np.zeros((3, 2))}, mesh)
    except ValueError as e:
        out["odd_batch"] = str(e)

    sv, ml = SmoothedValue(window_size=3), MetricLogger(window_size=3)
    for v, n in p["values"][rank]:
        sv.update(v, n)
        ml.update(loss=v, acc=v / 2)
    sv.synchronize_between_processes()
    ml.synchronize_between_processes()
    out["smoothed"] = (sv.count, sv.total, sv.global_avg, sv.median, sv.value)
    out["logger"] = ml.global_avg()

    out["retrieval"] = p["retrieval"] and _retrieval(rank, world, p["retrieval"])
    out["batchnorm"] = _batchnorm(rank, world, p["batchnorm"])
    return out


def _batchnorm(rank, world, p):
    """A training-form ``SparseBatchNorm`` on this rank's rows of the global
    batch, and the backward of ``sum(out * R)`` over them."""
    from situation3d_tpu_torch.sparse.conv import SparseBatchNorm
    from situation3d_tpu_torch.sparse.tensor import SparseVoxels
    bn = SparseBatchNorm(p["feats"].shape[-1])
    with torch.no_grad():
        for k, v in p["state"].items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    feats = torch.from_numpy(_rows(p["feats"], rank, world)).requires_grad_(True)
    mask = torch.from_numpy(_rows(p["mask"], rank, world))
    x = SparseVoxels(torch.zeros(*mask.shape, 3, dtype=torch.int32), feats, mask, 1)
    out = bn(x, use_running_average=False, momentum=p["momentum"])
    (out.feats * torch.from_numpy(_rows(p["R"], rank, world))).sum().backward()
    return {"out": out.feats.detach().numpy(), "mean": bn.mean.numpy(),
            "var": bn.var.numpy(), "feats_grad": feats.grad.numpy(),
            "scale_grad": bn.scale.grad.numpy(), "bias_grad": bn.bias.grad.numpy()}


def _retrieval(rank, world, p):
    from situation3d_tpu_torch.eval.retrieval import compute_sim_matrix
    from situation3d_tpu_torch.models.blip2_qformer import Blip2Qformer
    from situation3d_tpu_torch.train.tasks import RetrievalTask
    cfg = apply_overrides(Config(), p["options"])
    model = Blip2Qformer(cfg.blip2.qformer, device="cpu")
    model.load_state_dict(p["state"])
    part = compute_sim_matrix(model, *p["args"], k_test=p["k_test"], encode_batch=4,
                              rerank_chunk=3, rank=rank, world=world)
    merged = [C.psum(torch.from_numpy(s)).numpy() for s in part]
    task = RetrievalTask(cfg, k_test=p["k_test"], device="cpu")
    return {"merged": merged,
            "metrics": task.evaluation(model, *p["args"], *p["pairs"])}


# ---------------------------------------------------------------------------
# whole training steps

def params_of(model):
    return {n: t.detach().clone() for n, t in model.named_parameters()}


def grads_of(model):
    return {n: t.grad.detach().clone() for n, t in model.named_parameters()
            if t.grad is not None}


def capture_grads(model, optimizer, into: list) -> None:
    """Record the gradients ``optimizer.step`` is handed (averaged over the
    ranks, after the NaN guard) into ``into``, one dict a step."""
    step = optimizer.step

    def capturing():
        into.append(grads_of(model))
        return step()
    optimizer.step = capturing


def sig3d_setup(options, device="cpu"):
    """The tiny SIG3D in float32 with seeded weights and a fresh train state
    (same seeds on every rank)."""
    from situation3d_tpu_torch.models.sig3d import SIG3D, init_random_weights
    from situation3d_tpu_torch.train.trainer import create_train_state
    cfg = apply_overrides(Config(), options)
    model = SIG3D(cfg, cfg.data.num_answers, device=device)
    init_random_weights(model, 1)
    return cfg, model, create_train_state(cfg, model, steps_per_epoch=10, seed=0)


def sig3d_steps(cfg, model, state, batches, mesh=None):
    """One SIG3D step a global batch (this rank's rows of it); the losses
    (the global batch's), the gradients and the parameters after each."""
    from situation3d_tpu_torch.train.trainer import train_step
    out = {"loss": [], "params": [], "grads": []}
    capture_grads(model, state.optimizer, out["grads"])
    for b in batches:
        m = train_step(cfg, state, b if mesh is None else shard_batch(b, mesh), mesh)
        out["loss"].append(float(C.pmean(m["loss"])))
        out["params"].append(params_of(model))
    return out


def stage1_setup(options, device="cpu"):
    from situation3d_tpu_torch.models.blip2_qformer import Blip2Qformer
    from situation3d_tpu_torch.train.optim import make_optimizer
    cfg = apply_overrides(Config(), options)
    model = Blip2Qformer(cfg.blip2.qformer, device=device, seed=cfg.train.seed)
    return cfg, model, make_optimizer(cfg.train, model)[0]


def stage1_step(model, optimizer, batch, gumbel, axis=None):
    """One stage-1 step with the global batch's Gumbel noise; the loss
    terms (the global batch's), the gradients, the parameters after it."""
    g = tuple(torch.from_numpy(x) for x in gumbel)
    out = model(batch, negatives_axis=axis, gumbel=g)
    optimizer.discard()
    out["loss"].backward()
    C.pmean_grads(model.parameters())
    grads = grads_of(model)
    optimizer.step()
    return {"terms": {k: float(C.pmean(v.detach())) for k, v in out.items()},
            "grads": grads, "params": params_of(model)}


def t5_setup(options, device="cpu"):
    from situation3d_tpu_torch.models.blip2_t5 import Blip2T5
    from situation3d_tpu_torch.train.blip2_trainer import Blip2TrainState, make_blip2_optimizer
    cfg = apply_overrides(Config(), options)
    model = Blip2T5(cfg.blip2, device=device, seed=cfg.train.seed)
    return cfg, model, Blip2TrainState(model, make_blip2_optimizer(cfg, model, 10)[0], 0)


def t5_steps(cfg, state, batches, mesh=None):
    """One 3D-LLM step a global batch (this rank's rows of it)."""
    from situation3d_tpu_torch.train.blip2_trainer import blip2_train_step
    grads, out = [], []
    capture_grads(state.model, state.optimizer, grads)
    for b in batches:
        m = blip2_train_step(cfg, state, b if mesh is None else shard_batch(b, mesh), mesh)
        out.append({"loss": float(C.pmean(m["loss"])), "rank_loss": float(m["loss"]),
                    "finite": float(m["grads_finite"]), "updates": state.optimizer.updates,
                    "params": params_of(state.model),
                    "adam": [(s["exp_avg"].clone(), s["exp_avg_sq"].clone())
                             for s in state.optimizer.adamw.state.values()]})
    return out, grads


def steps_job(rank, world, p):
    mesh = make_mesh(MeshConfig(), "cpu")
    out = {}
    cfg, model, state = sig3d_setup(p["sig3d_options"])
    out["sig3d"] = sig3d_steps(cfg, model, state, p["sig3d_batches"], mesh)
    _, model, opt = stage1_setup(p["stage1_options"])
    out["stage1"] = stage1_step(model, opt, shard_batch(p["stage1_batch"], mesh),
                                p["gumbel"], axis=mesh.data_axis)
    cfg, _, state = t5_setup(p["t5_options"])
    out["t5"] = t5_steps(cfg, state, p["t5_batches"], mesh)[0]
    out["generation"] = generate(cfg, state.model, p["eval_batches"], p["eval_dir"], mesh)
    return out


def generate(cfg, model, batches, out_dir, mesh=None):
    """``evaluate_generation`` (greedy answers, the per-rank result files and
    their merge) over ``batches``; the answers as token strings."""
    from situation3d_tpu_torch.train.blip2_trainer import evaluate_generation
    return evaluate_generation(cfg, model, iter(batches), lambda t: " ".join(map(str, t)),
                               output_dir=str(out_dir), mesh=mesh)


JOBS = {"parallel": parallel_job, "steps": steps_job}
