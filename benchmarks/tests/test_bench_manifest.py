"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in it
has its file."""
import json
import re

import pytest

from benchmarks.harness.cell import BENCH, ROOT, cell_files

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MAN["paths"] == ["benchmarks"]
    assert all("/" != w[0] and ".." not in w for w in MAN["command"])


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _reports(cell):
    return {m["name"] for m in _metrics() if "workloads" not in m or cell in m["workloads"]}


def test_every_moved_metric_is_reported_by_its_cells():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in _reports(cell), (m["name"], cell)


def test_every_cell_reports_enough_and_every_config_has_a_cell():
    per_layer = {m["name"] for m in MAN["per_layer"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for cell in CELLS:
        got = _reports(cell)
        assert "setup_s" in got and len(got & e2e) >= 2 and got & per_layer, cell
    assert {c["name"] for c in MAN["configs"]} == {w["config"] for w in MAN["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files(cell):
    f = cell_files(cell)
    assert f["limits"], f"no limits for {cell}"
    for m in MAN["per_layer"]:
        if cell in m.get("workloads", CELLS):
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    entry = {c["name"]: c for c in MAN["configs"]}[f["cell"]["config"]]
    assert entry["file"].startswith("benchmarks/")
    assert f["config"]["reduced"] == entry["reduced"]
