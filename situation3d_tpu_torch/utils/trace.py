"""Named spans at the port's layer boundaries, on the profiler's clock.

``with span("sig3d.plan"):`` marks a stretch of host code as one layer's
work. While a ``torch.profiler`` records (``log.profile_steps``, a traced
benchmark run), the span is a ``record_function`` range: it shows in the
Chrome trace and in ``prof.events()`` as a user annotation, on the clock the
device's kernels are on, and the kernels launched inside it can be laid to
it. While none records, ``span`` returns one shared no-op and costs the read
of the profiler's flag.

A batch's top-level span carries a request id: the training step's number,
or ``BATCH``, which draws this process's next batch number. The id is the
range's one argument, so it shows where the profiler records shapes
(``record_shapes=True``: ``FunctionEvent.concrete_inputs``, "Concrete
Inputs" in the Chrome trace). Spans nest on their thread; ``top=True`` opens
a span only where no span is open on the thread, so ``sig3d.forward`` stays
shut under ``train.step`` or ``serving.answer``.

The spans, outermost first: ``train.step`` (``train.loss``,
``train.backward``, ``train.allreduce``, ``train.nan_guard``,
``train.optimizer``, ``train.metrics``), ``train.fetch``,
``sig3d.forward``, ``serving.encode``, ``serving.answer`` (``sig3d.input``,
``sig3d.language``, ``sig3d.plan``, ``sig3d.encoder``, ``sig3d.pool``,
``sig3d.fusion``; on a card in evaluation form ``sig3d.question`` in place of
``sig3d.language`` and ``sig3d.fusion``), ``blip2.predict`` (``blip2.qformer``, then
``t5.encoder`` and ``t5.decode_step``, or ``lfm2.prefill`` and
``lfm2.decode_step``). The 3D-LLM's training step has ``train.step`` with
``train.loss``, ``train.backward``, ``train.nan_guard`` and
``train.optimizer``.
"""
from __future__ import annotations

import functools
import itertools
import threading

import torch
from torch.autograd import profiler as _profiler

BATCH = object()            # ``request=BATCH``: this process's next batch number
_batches = itertools.count(1)
_depth = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.args)
        _depth.n = getattr(_depth, "n", 0) + 1
        return None

    def __exit__(self, *exc):
        _depth.n -= 1
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str, request=None, top: bool = False):
    """A context manager: the profiler's range ``name`` while a profiler
    records, else a shared no-op. ``request``: an int, or ``BATCH``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if top and getattr(_depth, "n", 0):
        return _OFF
    if request is BATCH:
        request = next(_batches)
    return _On(name, () if request is None else (int(request),))


def spanned(name: str, request=None, top: bool = False):
    """``span`` as a decorator: each call of the function is one span."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, request, top):
                return fn(*args, **kwargs)
        return inner
    return wrap
