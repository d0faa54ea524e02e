"""The traced run's reading of ``torch.profiler``: a schedule profiles one
steady batch in every few across the whole window, and each profiled cycle
is reduced in the process (no trace file is written) to

- the device's busy seconds (the union of every kernel, copy and set on the
  device) and the wall seconds of the profiled batches;
- the kernel launches the host issued in them;
- device seconds by operation name, and the idle gaps of the device summed
  by the host operation that was running when each began;
- the work (samples, questions) the profiled batches completed.

Batches that the profiler neither recorded nor warmed up are timed on their
own (``quiet_s``, ``quiet_units``), so a rate read in the traced run leaves
the profiler's own cost out.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerAction, ProfilerActivity

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")
_RUNTIME = ("cuda", "cu", "Memcpy", "Memset")


@dataclass
class TraceSummary:
    busy_s: float = 0.0
    window_s: float = 0.0
    launches: int = 0
    units: float = 0.0
    quiet_s: float = 0.0
    quiet_units: float = 0.0
    device_ops: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    idle_gaps: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    profiled_tags: List = field(default_factory=list)
    quiet_tags: List = field(default_factory=list)

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of ``parts``."""
        return sum(s for n, s in self.device_ops.items() if any(p in n for p in parts))

    def top(self, table: Dict[str, float], n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_name(stack) -> str:
    for e in reversed(stack):
        if not e.name.startswith(_RUNTIME):
            return e.name
    return stack[-1].name if stack else "python, between operations"


def reduce_events(events, summary: TraceSummary) -> None:
    """Fold one profiled cycle's ``FunctionEvent``s into ``summary``."""
    steps = [e for e in events if e.name.startswith("ProfilerStep")]
    if not steps:
        return
    thread = steps[0].thread
    spans = _merge([(e.time_range.start, e.time_range.end) for e in steps])
    # the device's own operations: kernels, copies, sets (the profiler also
    # mirrors host annotations, the step markers among them, onto the device)
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep") and e.name not in host_names
           and not getattr(e, "is_user_annotation", False)]
    busy = _merge([(e.time_range.start, e.time_range.end) for e in dev])
    for e in dev:
        summary.device_ops[e.name] += e.time_range.elapsed_us() * 1e-6
    summary.launches += sum(1 for e in events if e.name in LAUNCHES)
    # busy time and the gaps, inside the profiled batches only
    gaps = []
    for s0, s1 in spans:
        summary.window_s += (s1 - s0) * 1e-6
        cursor = s0
        for b0, b1 in busy:
            if b1 <= s0 or b0 >= s1:
                continue
            b0, b1 = max(b0, s0), min(b1, s1)
            if b0 > cursor:
                gaps.append((cursor, b0))
            summary.busy_s += (b1 - b0) * 1e-6
            cursor = max(cursor, b1)
        if cursor < s1:
            gaps.append((cursor, s1))
    # name each gap by the innermost host operation running where it begins
    host = sorted((e for e in events if e.device_type == DeviceType.CPU and e.thread == thread
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda e: (e.time_range.start, -e.time_range.end))
    starts = [e.time_range.start for e in host]
    stack, i = [], 0
    for g0, g1 in sorted(gaps):
        while i < len(host) and starts[i] <= g0:
            while stack and stack[-1].time_range.end <= host[i].time_range.start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].time_range.end <= g0:
            stack.pop()
        summary.idle_gaps[_host_name(stack)] += (g1 - g0) * 1e-6


class Tracer:
    """Drives ``torch.profiler`` around a closed loop: ``with tracer.batch(units,
    tag):`` wraps one batch. ``every``: one batch in ``every`` is profiled
    (after one warm-up batch of the profiler). Without ``enabled`` it only
    counts."""

    def __init__(self, enabled: bool, every: int = 4):
        self.enabled, self.every = enabled, max(int(every), 3)
        self.summary = TraceSummary()
        self._prof = None
        self._step = 0

    def _action(self, step: int) -> ProfilerAction:
        phase = step % self.every
        if phase == self.every - 1:
            return ProfilerAction.RECORD_AND_SAVE
        if phase == self.every - 2:
            return ProfilerAction.WARMUP
        return ProfilerAction.NONE

    def __enter__(self):
        if self.enabled:
            self._prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=self._action, on_trace_ready=self._ready)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None
        return False

    def _ready(self, prof) -> None:
        reduce_events(prof.events(), self.summary)

    def batch(self, units: float, tag=None):
        return _Batch(self, units, tag)


class _Batch:
    def __init__(self, tracer: Tracer, units: float, tag):
        self.t, self.units, self.tag = tracer, units, tag

    def __enter__(self):
        self.action = self.t._action(self.t._step) if self.t.enabled else ProfilerAction.NONE
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        s = self.t.summary
        if self.action == ProfilerAction.RECORD_AND_SAVE:
            s.units += self.units
            s.profiled_tags.append(self.tag)
        elif self.action == ProfilerAction.NONE:
            s.quiet_s += t1 - self.t0
            s.quiet_units += self.units
            s.quiet_tags.append(self.tag)
        if self.t._prof is not None:
            self.t._prof.step()
        self.t._step += 1
        return False

