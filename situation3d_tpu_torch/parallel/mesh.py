"""The data-parallel layout of a run (port of
``situation3d_tpu/parallel/mesh.py``).

The JAX package builds a ``(data, model)`` device mesh in one process and
shards the global batch over its ``data`` axis; pjit computes the global
loss and applies one update. The port runs one process a card under
``torch.distributed`` (``parallel/collectives.py``): ``make_mesh`` names this
process's rank, the run's size and its card; ``shard_batch`` keeps the
rank's contiguous rows ``[r*B/w, (r+1)*B/w)`` of the global batch that every
rank builds alike, as ``shard_batch`` splits it over the ``data`` axis there;
``replicated`` broadcasts the parameters from rank 0. Random draws whose
shape has the batch in front (token sampling, dropout masks, hard
negatives) come from a ``ShardedGenerator``: drawn at the global batch's
shape from a generator seeded alike on every rank and cut to the rank's
rows, so a run of ``w`` processes draws the numbers a one-process run draws.

Without a process group the mesh has one rank and every function here
leaves the one-process code path as it is.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from situation3d_tpu_torch.config import MeshConfig
from situation3d_tpu_torch.device import resolve_device, tree_to_device
from situation3d_tpu_torch.parallel import collectives


@dataclass(frozen=True)
class Mesh:
    """This process's place in the run: ``rank`` of ``world`` processes,
    on ``device``; the batch is split over ``data_axis``."""
    world: int
    rank: int
    device: torch.device
    data_axis: str = "data"


def make_mesh(cfg: MeshConfig, device="cuda") -> Mesh:
    """The mesh of the process group that is up (one rank without one).
    ``device="cuda"`` with no index takes ``cuda:{LOCAL_RANK}`` under a
    process group (``torchrun`` sets it); an explicit index is kept (ranks
    that share one card). A CUDA device that is not there raises."""
    if cfg.model_parallel > 1:
        raise NotImplementedError(
            f"mesh.model_parallel={cfg.model_parallel}: tensor parallelism of T5 is not "
            "ported (FlanT5-XL fits one card); use model_parallel=1")
    w, r = collectives.world(), collectives.rank()
    if cfg.data_parallel > 0 and cfg.data_parallel != w:
        raise ValueError(
            f"mesh.data_parallel={cfg.data_parallel} but the run has {w} process(es); "
            "use -1 (every process) or the process count")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and collectives.active():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", r)))
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return Mesh(world=w, rank=r, device=dev, data_axis=cfg.data_axis)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size``."""
    if batch_size % mesh.world:
        raise ValueError(f"the global batch of {batch_size} does not split over "
                         f"{mesh.world} processes")
    n = batch_size // mesh.world
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every leaf of a global host batch, on the rank's
    device. One rank: the batch as it is (the model moves it)."""
    if mesh.world == 1:
        return batch
    if "plan" in batch:
        raise NotImplementedError("a host-built UNet plan indexes the global batch's "
                                  "voxels: build the plan on the device at world > 1")
    rows = batch_sharding(mesh, len(next(iter(batch.values()))))
    return tree_to_device({k: v[rows] for k, v in batch.items()}, mesh.device)


def replicated(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, so every
    rank starts from the same values."""
    if mesh.world > 1:
        import torch.distributed as dist
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                buf = collectives._wire(t)
                dist.broadcast(buf, 0)
                t.copy_(buf.to(t.device))
    return module


class ShardedGenerator:
    """A ``torch.Generator`` seeded alike on every rank whose draws of a
    batch-leading shape are made at the global batch's shape and cut to
    this rank's rows (``draw``)."""

    def __init__(self, generator: torch.Generator, mesh: Mesh):
        self.generator, self.mesh = generator, mesh

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def draw(self, fn, shape, *args, **kwargs) -> torch.Tensor:
        full = fn(*args, (shape[0] * self.mesh.world, *shape[1:]),
                  generator=self.generator, **kwargs)
        return full[batch_sharding(self.mesh, full.shape[0])]


def draw(fn, shape, *args, generator=None, **kwargs) -> torch.Tensor:
    """``fn(*args, shape, generator=generator, **kwargs)`` (``torch.rand``,
    ``torch.randint``); from a ``ShardedGenerator`` the rank's rows of the
    global batch's draw."""
    if isinstance(generator, ShardedGenerator):
        return generator.draw(fn, shape, *args, **kwargs)
    return fn(*args, shape, generator=generator, **kwargs)


def sharded(generator, mesh: Optional[Mesh]):
    """``generator`` as the rank's view of the global batch's draws; one
    rank (or no mesh): ``generator`` itself."""
    if generator is None or mesh is None or mesh.world == 1:
        return generator
    return ShardedGenerator(generator, mesh)
