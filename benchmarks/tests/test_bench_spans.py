"""``harness/spans.py`` on synthetic profiles: device operations laid to the
spans open where they were launched, the backward's launches from
autograd's thread laid to the loop thread's spans, the device-side mirrors
where no launch is linked, the coverage, the idle gaps; the harness's own
summary unmoved by span events; the span metrics' readers and entries."""
import json
import re

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

from benchmarks.harness.cell import BENCH, ROOT
from benchmarks.harness.spans import SPAN_METRICS, SpanTable, reduce_spans
from benchmarks.harness.trace import TraceSummary, reduce_events
from benchmarks.metrics._spans import coverage_pct, span_us

LOOP, AUTOGRAD = 1, 2
SPANS = [("train.step", 10, 900), ("sig3d.plan", 20, 100), ("train.backward", 200, 500),
         ("train.optimizer", 600, 700)]
# (correlation id, launching thread, launch time, kernel, device start, device end)
KERNELS = [(101, LOOP, 30, "k_plan", 40, 140), (102, AUTOGRAD, 250, "k_bwd", 300, 400),
           (103, LOOP, 650, "k_opt", 660, 720), (104, LOOP, 950, "k_tail", 960, 980)]


def _ev(i, name, thread, t0, t1, dev=DeviceType.CPU, ann=False):
    return FunctionEvent(id=i, name=name, thread=thread, start_us=t0, end_us=t1,
                         device_type=dev, is_user_annotation=ann)


def _profile(spans=True, linked=True, mirrors=True):
    ev = [_ev(1, "ProfilerStep*", LOOP, 0, 1000, ann=True),
          _ev(4, "Optimizer.step#AdamW.step", LOOP, 640, 690, ann=True),
          _ev(2, "aten::mm", LOOP, 25, 40), _ev(3, "aten::add", AUTOGRAD, 240, 260)]
    for cid, thread, t, name, d0, d1 in KERNELS:
        if linked:
            ev.append(_ev(cid, "cudaLaunchKernel", thread, t, t + 5))
        ev.append(_ev(cid if linked else 900 + cid, name, 7, d0, d1, dev=DeviceType.CUDA))
    if spans:
        ev += [_ev(10 + k, n, LOOP, a, b, ann=True) for k, (n, a, b) in enumerate(SPANS)]
        if mirrors:     # each range on the device: from its first kernel to its last one's end
            ev += [_ev(20, "train.step", 7, 40, 720, DeviceType.CUDA, True),
                   _ev(21, "sig3d.plan", 7, 40, 140, DeviceType.CUDA, True),
                   _ev(22, "train.backward", 7, 300, 400, DeviceType.CUDA, True),
                   _ev(23, "train.optimizer", 7, 660, 720, DeviceType.CUDA, True)]
    return ev


def _table(**kw) -> SpanTable:
    t = SpanTable()
    reduce_spans(_profile(**kw), t)
    return t


def test_device_time_goes_to_the_spans_open_at_its_launch():
    t = _table()
    r = t.rows
    assert r["sig3d.plan"].device_s == pytest.approx(100e-6)
    assert r["train.optimizer"].device_s == pytest.approx(60e-6)
    assert r["train.step"].device_s == pytest.approx(260e-6)      # child spans included
    assert (r["sig3d.plan"].launches, r["train.optimizer"].launches, r["train.step"].launches) \
        == (1, 1, 3)
    assert r["train.step"].host_s == pytest.approx(890e-6) and r["train.step"].calls == 1
    assert not any(n.startswith(("ProfilerStep", "Optimizer.")) for n in r)
    assert t.top()[0] == ["train.step", r["train.step"].host_s, r["train.step"].device_s, 3,
                          r["train.step"].idle_s]


def test_the_autograd_threads_launches_go_to_the_loop_threads_spans():
    r = _table().rows
    assert r["train.backward"].device_s == pytest.approx(100e-6)
    assert r["train.backward"].launches == 1


def test_without_a_launch_link_the_device_side_ranges_decide():
    linked, mirrored = _table().rows, _table(linked=False).rows
    for name in ("sig3d.plan", "train.backward", "train.optimizer", "train.step"):
        assert mirrored[name].device_s == pytest.approx(linked[name].device_s), name


def test_coverage_and_idle():
    t = _table()
    assert t.busy_s == pytest.approx(280e-6)
    assert t.coverage() == pytest.approx(260 / 280)       # k_tail ran after every span
    # gaps begin at 0 (no span), 140 and 720 (train.step), 400 (train.backward), 980 (none)
    assert t.rows["train.step"].idle_s == pytest.approx(400e-6)
    assert t.rows["train.backward"].idle_s == pytest.approx(260e-6)
    assert t.rows["sig3d.plan"].idle_s == 0.0
    assert _table(spans=False).coverage() is None        # a program without spans


def test_the_harness_summary_is_unmoved_by_span_events():
    plain, spanned = TraceSummary(), TraceSummary()
    reduce_events(_profile(spans=False), plain)
    reduce_events(_profile(), spanned)
    for key in ("busy_s", "window_s", "launches", "units"):
        assert getattr(plain, key) == getattr(spanned, key), key
    assert dict(plain.device_ops) == dict(spanned.device_ops)
    assert sum(plain.idle_gaps.values()) == pytest.approx(sum(spanned.idle_gaps.values()))
    # trace.py names a gap by the innermost host event where it begins, and a
    # span is one: a gap inside a span but between operations takes its name
    assert set(spanned.idle_gaps) - set(plain.idle_gaps) == {"train.step", "train.backward"}


def test_the_readers_read_a_unit_and_find_nothing_without_a_table():
    s = TraceSummary(units=2.0)
    ctx = {"summary": s}
    assert span_us("sig3d.plan", "device")(ctx) is None and coverage_pct(ctx) is None
    s.spans = _table()
    assert span_us("sig3d.plan", "device")(ctx) == pytest.approx(50.0)
    assert span_us("sig3d.plan", "host")(ctx) == pytest.approx(40.0)
    assert span_us("t5.decode_step", "device")(ctx) is None
    assert coverage_pct(ctx) == pytest.approx(100 * 260 / 280)


def test_the_span_metrics_are_entries_the_manifest_takes():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = json.loads((BENCH / "harness" / SPAN_METRICS).read_text())
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    taken = {m["name"] for m in man["per_layer"]}
    assert len(entries) == 37
    for m in entries:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$", m["name"]) and m["name"] not in taken
        assert m["source"] == "program_span" and m["unit"] in ("us", "%")
        assert m["better"] == ("higher" if m["unit"] == "%" else "lower")
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert len({m["name"] for m in entries}) == len(entries)
