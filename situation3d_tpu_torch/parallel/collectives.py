"""Collectives across the processes of a data-parallel run (port of
``situation3d_tpu/parallel/collectives.py``).

The JAX package runs one process that shards the global batch over its
devices; pjit inserts the collectives. The port runs one process a card
under ``torch.distributed``, so each collective here is an explicit call on
the default process group. Every function is the identity (``[x]`` for the
host gather) when no process group is up, so a one-process run takes
exactly the code path it takes without this module.

Under the ``gloo`` backend (the CPU, or several ranks sharing one card) a
CUDA tensor is copied to the host for the collective and back: gloo refuses
some collectives on CUDA tensors (``all_gather``, send / receive), and one
staged path serves them all. The model itself never leaves the card. Under
NCCL a host tensor (a metric) goes to the card and back.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from situation3d_tpu_torch.utils.trace import span


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device="cuda") -> None:
    """``init_process_group`` from an explicit rendezvous
    (``coordinator_address`` ``"host:port"``, ``num_processes``,
    ``process_id``) or, without one, from the environment ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend
    is ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU unless
    ``backend`` names one (``gloo`` also runs ranks that share one card)."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend)


@contextlib.contextmanager
def launched(device="cuda"):
    """Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment)
    the process group is up for the body of the ``with`` and torn down
    after it; otherwise nothing happens. The entry points run in one."""
    start = "RANK" in os.environ and "WORLD_SIZE" in os.environ and not active()
    if start:
        initialize_multihost(device=device)
    try:
        yield
    finally:
        if start:
            dist.destroy_process_group()


def active() -> bool:
    """True when a process group is up."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if active() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if active() else 0


def barrier() -> None:
    if active():
        dist.barrier()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` for a collective to write into,
    where the backend takes it: on the host for gloo, on this process's
    card for NCCL (a host value such as a metric goes there and back)."""
    backend = dist.get_backend()
    dev = x.device
    if backend == "gloo" and x.is_cuda:
        dev = torch.device("cpu")
    elif backend == "nccl" and not x.is_cuda:
        dev = torch.device("cuda", torch.cuda.current_device())
    return x.detach().to(dev, copy=True).contiguous()


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes (a value, not differentiated)."""
    if not active():
        return x
    buf = _wire(x)
    dist.all_reduce(buf)
    return buf.to(x.device)


class _PSum(torch.autograd.Function):
    """``psum`` whose backward sums the cotangents over the processes too:
    a value every process reads feeds every process's loss."""

    @staticmethod
    def forward(ctx, x):
        return psum(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g)


def psum_differentiable(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes, differentiated as the sum over
    the global batch: statistics of the whole batch (``SparseBatchNorm`` in
    training form) give each process the gradient JAX's pjit gives it."""
    if not active():
        return x
    return _PSum.apply(x)


def pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the processes (gradient and metric averaging)."""
    if not active():
        return x
    return psum(x) / world()


def pmin(x: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the processes."""
    if not active():
        return x
    buf = _wire(x)
    dist.all_reduce(buf, op=dist.ReduceOp.MIN)
    return buf.to(x.device)


class _AllGather(torch.autograd.Function):
    """``[world, *x.shape]``; the backward is JAX's VJP of ``all_gather``,
    a reduce-scatter: each process gets the sum over processes of the
    cotangents of its own slice. Taken as an all-reduce and a slice, which
    every backend runs."""

    @staticmethod
    def forward(ctx, x):
        buf = _wire(x)
        parts = [torch.empty_like(buf) for _ in range(world())]
        dist.all_gather(parts, buf)
        return torch.stack(parts).to(x.device)

    @staticmethod
    def backward(ctx, g):
        return psum(g)[rank()]


def all_gather(x: torch.Tensor, tiled: bool = False) -> torch.Tensor:
    """Every process's ``x``, in rank order: stacked on a new leading axis,
    or with ``tiled`` concatenated along axis 0. Differentiable: gathered
    negatives carry gradient back to the process that made them."""
    if not active():
        return x if tiled else x[None]
    out = _AllGather.apply(x)
    return out.flatten(0, 1) if tiled else out


def ppermute_ring(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Process ``r`` sends ``x`` to ``(r + shift) % world`` and returns what
    ``(r - shift) % world`` sent."""
    n = world()
    if n == 1 or shift % n == 0:
        return x
    r = rank()
    send = _wire(x)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (r + shift) % n),
           dist.P2POp(dist.irecv, recv, (r - shift) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


def process_gather_host(x) -> list:
    """Every process's host object ``x`` (arrays, lists of results), in rank
    order: the result merge of an evaluation."""
    if not active():
        return [x]
    out: List = [None] * world()
    dist.all_gather_object(out, x)
    return out


def pmean_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the ``.grad`` of ``params`` over the processes in place, one
    flattened all-reduce a dtype. Parameters without a ``.grad`` (off the
    loss's path on every process alike, such as the UNet's decoder in
    unfrozen SIG3D training) are left out and keep ``None``."""
    if not active():
        return
    with span("train.allreduce"):
        by_dtype: dict = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = pmean(torch.cat([g.reshape(-1) for g in grads]))
            offset = 0
            for g in grads:
                g.copy_(flat[offset: offset + g.numel()].view_as(g))
                offset += g.numel()


def token_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / count`` as one process's term of a mean over the global
    batch's tokens: ``total / psum(count) * world``, so that averaging the
    processes' terms (and their gradients) gives the global token mean even
    where the processes hold different token counts. Without a process
    group, ``total / max(count, 1)``."""
    if not active():
        return total / count.clamp(min=1.0)
    return total / psum(count.detach()).clamp(min=1.0) * world()
