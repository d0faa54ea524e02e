"""Greedy decoding for the port's decoders (``models/t5.py``,
``models/blip2_lfm2.py``): the tokens' static state, the step loop, and the
steps captured as CUDA graphs. SIG3D's question side
(``models/sig3d.py:QuestionGraphs``) is captured the same way, as one step.

A decode key (its shapes, ids and device) gets static buffers and one graph
per step index, captured at the key's first call in one memory pool on a
side stream, after a few eager steps there (cuBLAS and the allocator warm up
off the graph); later calls replay. A model keeps its ``GRAPH_KEYS`` most
recent keys and drops them all when the storage its steps read moved (a
graph reads its tensors through their addresses); a copy of the model keeps
none. Before each capture or replay the compute-dtype copies of the
weights the steps read are made or refreshed in place
(``layers.refresh_copies``), since no Python runs inside a replay. Steps
run eagerly on the CPU, with grad on, or while a stream captures.

A model gives the loop its step, ``step(i, check)``: its decode step, then
:meth:`GreedyTokens.emit` of token ``i``. Between steps one flag is read
from the device, to stop once every row has ended.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Callable, Hashable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from situation3d_tpu_torch.models.layers import Dense, refresh_copies
from situation3d_tpu_torch.utils.trace import span

GRAPH_KEYS = 4      # the keys a model keeps captured, the most recent
GRAPH_WARMUP = 3    # eager steps on the capture stream before the first capture


class GreedyTokens:
    """The tokens of one greedy decode key, static so that captured steps
    write them: the emitted tokens ``out``, the next input ``tok``, the rows
    ``done`` and whether all are (``finished``)."""

    def __init__(self, batch: int, max_len: int, device):
        self.out = torch.empty((batch, max_len), dtype=torch.long, device=device)
        self.tok = torch.empty((batch, 1), dtype=torch.long, device=device)
        self.done = torch.empty(batch, dtype=torch.bool, device=device)
        self.finished = torch.empty((), dtype=torch.bool, device=device)

    def reset(self, start_id: int, pad_id: int) -> None:
        """A new batch: nothing emitted, ``start_id`` the next input."""
        self.out.fill_(pad_id)
        self.tok.fill_(start_id)
        self.done.zero_()

    def emit(self, i: int, logits: torch.Tensor, eos_id: int, pad_id: int, check: bool) -> None:
        """Token ``i`` from ``logits`` [B, vocab], in place and without a host
        read: the next token (pad once its row is done) into ``out[:, i]``
        and ``tok``, the rows done and, where ``check``, whether all are."""
        nxt = logits.argmax(-1).masked_fill(self.done, pad_id)
        self.out[:, i] = nxt
        self.done |= nxt == eos_id
        self.tok.copy_(nxt[:, None])
        if check:
            self.finished.copy_(self.done.all())


def greedy_loop(tokens: GreedyTokens, steps: range, step: Callable[[int, bool], object],
                replay: Optional[Callable[[int], None]], name: str) -> torch.Tensor:
    """Greedy tokens ``steps``: each from ``replay(i)`` where the steps are
    captured, else ``step(i, check)``, inside a span ``name`` that holds the
    token and the check that ends the loop after it. Returns ``tokens.out``,
    a copy where captured buffers serve the key's next call."""
    for i in steps:
        check = i + 1 < steps.stop
        with span(name):
            if replay is not None:
                replay(i)
            else:
                step(i, check)
            if check and bool(tokens.finished):
                break
    return tokens.out.clone() if replay is not None else tokens.out


def eager(device: torch.device) -> bool:
    """Whether steps on ``device`` run eagerly instead of from graphs."""
    return (device.type != "cuda" or torch.is_grad_enabled()
            or torch.cuda.is_current_stream_capturing())


def capture_steps(step: Callable[[int, bool], torch.Tensor], steps: range, device
                  ) -> Tuple[List[torch.cuda.CUDAGraph], List[torch.Tensor]]:
    """``step(i, check)`` for each ``i`` of ``steps`` captured as a graph
    (``check`` false at the last), after up to ``GRAPH_WARMUP`` eager steps
    on the same buffers; the graphs and each one's output in the pool."""
    here = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(here)
    graphs, outputs = [], []
    with torch.cuda.device(device), torch.cuda.stream(side):
        pool = torch.cuda.graph_pool_handle()
        for i in steps[:GRAPH_WARMUP]:
            step(i, True)
        for i in steps:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=side):
                outputs.append(step(i, i + 1 < steps.stop))
            graphs.append(g)
    here.wait_stream(side)
    return graphs, outputs


def storage(modules: Sequence[nn.Module]) -> tuple:
    """Where ``modules``' parameters and buffers live: the captured steps
    read them through these addresses."""
    return tuple(t.data_ptr() for m in modules
                 for t in itertools.chain(m.parameters(), m.buffers()))


class GraphCache:
    """A model's captures by key, the ``GRAPH_KEYS`` most recent; all
    dropped when the :func:`storage` of the modules the steps read changes.
    ``copied``: those modules' :class:`Dense` layers held in another dtype
    than they compute in, whose copies each lookup refreshes."""

    def __init__(self):
        self.storage, self.keys, self.copied = None, OrderedDict(), []

    def __deepcopy__(self, memo):
        return type(self)()

    def lookup(self, key: Hashable, modules: Sequence[nn.Module], make: Callable[[], object]
               ) -> Optional[object]:
        """The capture of ``key``, made by ``make()`` at its first call,
        after the copies of ``modules``' weights are brought up to date."""
        fingerprint = storage(modules)
        if fingerprint != self.storage:
            self.keys.clear()
            self.storage = fingerprint
            self.copied = [d for m in modules for d in m.modules()
                           if isinstance(d, Dense) and d.weight.dtype != d.dtype]
        refresh_copies(self.copied)
        if key in self.keys:
            self.keys.move_to_end(key)
            return self.keys[key]
        while len(self.keys) >= GRAPH_KEYS:
            self.keys.popitem(last=False)
        self.keys[key] = make()
        return self.keys[key]
