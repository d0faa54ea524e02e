"""The port's spans (``situation3d_tpu_torch/utils/trace.py``) read from a
traced run's profile. Each profiled cycle's user annotations fold into one
row per span name:

- ``host_s``: the span's wall seconds on the host, summed over its calls;
- ``device_s``: the union of the device operations launched inside it,
  child spans included;
- ``launches``: the kernel launches issued inside it, child spans included;
- ``idle_s``: the device's idle gaps that begin while it is the innermost
  span open on the loop's thread;
- ``calls``.

The table holds the port's spans: every user annotation but torch's own
(``TORCH_RANGES``). A device operation is laid to the spans open where the
runtime call that launched it ran (the profiler's correlation id links the
two); where the installed torch gives no such link, to the device-side
mirrors of the ranges (``gpu_user_annotation``) that hold its start. A
launch on a thread with no span open (autograd's, in the backward) goes to
the spans open on the loop's thread at that moment. ``covered_s`` is the
busy device time of the profiled batches laid to any span; ``busy_s`` that
of all operations, as ``harness/trace.py`` reckons it.

``python3 -m benchmarks.harness.spans --workload <cell> --seed <n> --seconds
<s>`` is one traced run of a cell (``harness/main.py:run_cell``) whose
result line also holds the span table's ten rows of most device time
(``breakdown.spans``: ``[name, host_s, device_s, launches, idle_s]``), the
span metrics of ``span_metrics.json`` that list the cell, and the profiled
batches' units (``profiled_units``).
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torch.autograd import DeviceType

from benchmarks.harness.trace import LAUNCHES, Tracer, _merge, reduce_events

SPAN_METRICS = "span_metrics.json"
# torch's own ranges: the profiler's step, the optimizers' ``step`` and ``zero_grad``
TORCH_RANGES = ("ProfilerStep", "Optimizer.")


@dataclass
class SpanRow:
    host_s: float = 0.0
    device_s: float = 0.0
    launches: int = 0
    idle_s: float = 0.0
    calls: int = 0


@dataclass
class SpanTable:
    rows: Dict[str, SpanRow] = field(default_factory=lambda: defaultdict(SpanRow))
    covered_s: float = 0.0
    busy_s: float = 0.0

    def top(self, n: int = 10) -> List[list]:
        rows = sorted(self.rows.items(), key=lambda kv: -kv[1].device_s)[:n]
        return [[k, r.host_s, r.device_s, r.launches, r.idle_s] for k, r in rows]

    def coverage(self) -> Optional[float]:
        """None where no span ran."""
        return self.covered_s / self.busy_s if self.rows and self.busy_s > 0 else None


def _start(e) -> float:
    return e.time_range.start


def _end(e) -> float:
    return e.time_range.end


def _stacks(spans, times) -> List[tuple]:
    """For each of ``times`` (ascending), the spans open there, outermost
    first (spans on one thread nest)."""
    order = sorted(spans, key=lambda e: (_start(e), -_end(e)))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and _start(order[i]) <= t:
            while stack and _end(stack[-1]) <= _start(order[i]):
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and _end(stack[-1]) <= t:
            stack.pop()
        out.append(tuple(stack))
    return out


def _open_at(spans_of: dict, loop, queries) -> List[tuple]:
    """The spans open at each ``(thread, time)`` query, on the loop's thread
    where the query's own thread has none."""
    out: List[tuple] = [()] * len(queries)
    by_thread = defaultdict(list)
    for i, (thread, t) in enumerate(queries):
        by_thread[thread].append(i)
    orphans = []
    for thread, idx in by_thread.items():
        idx.sort(key=lambda i: queries[i][1])
        for i, st in zip(idx, _stacks(spans_of.get(thread, ()), [queries[i][1] for i in idx])):
            out[i] = st
            if not st and thread != loop:
                orphans.append(i)
    orphans.sort(key=lambda i: queries[i][1])
    for i, st in zip(orphans, _stacks(spans_of.get(loop, ()), [queries[i][1] for i in orphans])):
        out[i] = st
    return out


def _union_s(intervals) -> float:
    return sum(e - s for s, e in _merge(intervals)) * 1e-6


def _clipped_s(intervals, windows) -> float:
    return sum(max(0.0, min(e, w1) - max(s, w0))
               for s, e in _merge(intervals) for w0, w1 in windows) * 1e-6


def reduce_spans(events, table: SpanTable) -> None:
    """Fold one profiled cycle's ``FunctionEvent``s into ``table``."""
    steps = [e for e in events if e.name.startswith("ProfilerStep")]
    if not steps:
        return
    loop = steps[0].thread
    windows = _merge([(_start(e), _end(e)) for e in steps])
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    host_names = {e.name for e in cpu}
    spans = [e for e in cpu if getattr(e, "is_user_annotation", False)
             and not e.name.startswith(TORCH_RANGES)]
    spans_of = defaultdict(list)
    for e in spans:
        spans_of[e.thread].append(e)
        row = table.rows[e.name]
        row.host_s += (_end(e) - _start(e)) * 1e-6
        row.calls += 1
    # the device's own operations, as harness/trace.py takes them
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep") and e.name not in host_names
           and not getattr(e, "is_user_annotation", False)]
    mirrors = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name in host_names and not e.name.startswith(TORCH_RANGES)]
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    launched = [runtime.get(e.id) for e in dev]
    launches = [e for e in cpu if e.name in LAUNCHES]
    queries = [(r.thread, _start(r)) for r in launched if r is not None]
    queries += [(e.thread, _start(e)) for e in launches]
    stacks = iter(_open_at(spans_of, loop, queries))
    device = defaultdict(list)
    covered = []
    for e, r in zip(dev, launched):
        if r is not None:
            names = {s.name for s in next(stacks)}
        else:
            names = {m.name for m in mirrors if _start(m) <= _start(e) < _end(m)}
        for n in names:
            device[n].append((_start(e), _end(e)))
        if names:
            covered.append((_start(e), _end(e)))
    for _ in launches:
        for n in {s.name for s in next(stacks)}:
            table.rows[n].launches += 1
    for n, iv in device.items():
        table.rows[n].device_s += _union_s(iv)
    busy = [(_start(e), _end(e)) for e in dev]
    table.busy_s += _clipped_s(busy, windows)
    table.covered_s += _clipped_s(covered, windows)
    # the idle gaps of the profiled batches, each to the innermost span where it begins
    merged = _merge(busy)
    gaps = []
    for w0, w1 in windows:
        cursor = w0
        for b0, b1 in merged:
            if b1 <= w0 or b0 >= w1:
                continue
            if b0 > cursor:
                gaps.append((cursor, b0))
            cursor = max(cursor, b1)
        if cursor < w1:
            gaps.append((cursor, w1))
    gaps.sort()
    for (g0, g1), st in zip(gaps, _stacks(spans_of.get(loop, ()), [g0 for g0, _ in gaps])):
        if st:
            table.rows[st[-1].name].idle_s += (g1 - g0) * 1e-6


class SpanTracer(Tracer):
    """The harness's tracer, which also reduces each profiled cycle's spans
    into ``summary.spans``."""

    def __init__(self, enabled: bool, every: int = 4):
        super().__init__(enabled, every)
        self.summary.spans = SpanTable()

    def _ready(self, prof) -> None:
        events = prof.events()
        reduce_events(events, self.summary)
        reduce_spans(events, self.summary.spans)


def span_metrics(workload: str) -> List[dict]:
    """The entries of ``span_metrics.json`` (``BENCHMARK.json``'s
    ``per_layer`` form) that list ``workload``."""
    from benchmarks.harness.cell import BENCH
    entries = json.loads((BENCH / "harness" / SPAN_METRICS).read_text())
    return [m for m in entries if workload in m["workloads"]]


def main(argv=None) -> int:
    import argparse
    import sys
    from unittest import mock

    import torch

    from benchmarks.harness import main as harness
    from benchmarks.harness.cell import ROOT, manifest
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    chips = {w["name"]: w for w in manifest()["workloads"]}[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s)", file=sys.stderr)
        return 3
    harness.fixed_cache_dirs(ROOT)
    torch.cuda.set_device(0)
    made: List[SpanTracer] = []

    def tracer(enabled: bool, every: int = 4) -> SpanTracer:
        made.append(SpanTracer(enabled, every))
        return made[-1]
    # run_cell builds its tracer by this name
    with mock.patch.object(harness, "Tracer", tracer):
        result = harness.run_cell(args.workload, args.seed, args.seconds, True, "cuda:0")
    summary = made[0].summary
    ctx = {"summary": summary}
    for m in span_metrics(args.workload):
        v = harness.read_metric(m["name"], ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["breakdown"]["spans"] = summary.spans.top()
    result["profiled_units"] = summary.units
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
