"""A configuration, a traffic mix and a per-layer metric are added as files
of their own, and the harness finds them by the names in BENCHMARK.json,
with no edit to any file that is there."""
import json
import shutil

from benchmarks.harness import cell, main
from benchmarks.tests.conftest import tiny_files


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "benchmarks"
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(cell.BENCH / d, bench / d)
    man = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
    # the new files
    conf = json.loads((bench / "configs" / "sig3d.json").read_text())
    conf["name"] = "sig3d_copy"
    (bench / "configs" / "sig3d_copy.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "answer.full_forward.json").read_text())
    mix["batch_size"] = 2
    (bench / "traffic" / "answer.pairs.json").write_text(json.dumps(mix))
    (bench / "metrics" / "rows_done.answer.py").write_text(
        "def read(ctx):\n    s = ctx['summary']\n    return s.quiet_units + s.units\n")
    (bench / "limits" / "sig3d_copy.answer.pairs.json").write_text(
        (bench / "limits" / "sig3d.answer.full_forward.json").read_text())
    man["configs"].append({"name": "sig3d_copy", "source": "https://example.org/copy",
                           "file": "benchmarks/configs/sig3d_copy.json", "reduced": [],
                           "why": "a copy"})
    man["workloads"].append({"name": "sig3d_copy.answer.pairs", "config": "sig3d_copy",
                             "traffic": "answer.pairs", "chips": 1, "why": "pairs"})
    for m in man["end_to_end"]:
        if "workloads" in m and "sig3d.answer.full_forward" in m["workloads"]:
            m["workloads"].append("sig3d_copy.answer.pairs")
    man["per_layer"].append({"name": "rows_done.answer", "unit": "q", "better": "higher",
                             "source": "program_counter", "layer": "entry",
                             "moves": "questions_per_s", "workloads": ["sig3d_copy.answer.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    monkeypatch.setattr(cell, "ROOT", tmp_path)
    monkeypatch.setattr(cell, "BENCH", bench)
    monkeypatch.setattr(main, "BENCH", bench)

    found = cell.cell_files("sig3d_copy.answer.pairs")
    assert found["config"]["name"] == "sig3d_copy" and found["traffic"]["batch_size"] == 2
    files = tiny_files("sig3d_copy.answer.pairs")
    files["traffic"]["batch_size"] = 2
    traced = main.run_cell("sig3d_copy.answer.pairs", 2 ** 33 + 5, 0.3, True, "cpu", files=files)
    assert traced["metrics"]["rows_done.answer"]["value"] > 0
    assert traced["correct"]
    plain = main.run_cell("sig3d_copy.answer.pairs", 2 ** 33 + 5, 0.3, False, "cpu", files=files)
    assert set(plain["metrics"]) == {"questions_per_s", "question_p95_ms", "setup_s"}
    assert list(plain)[-1] == "checks"
