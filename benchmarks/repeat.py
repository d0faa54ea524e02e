"""Run cells of ``BENCHMARK.json`` several times, each run a fresh process
(``python3 -m benchmarks.run``), one after another, and summarize them: for
each metric its median and its spread (the distance between the first and
third quartiles of ``statistics.quantiles(values, n=4)``, over the median).

    python3 -m benchmarks.repeat --workload sig3d.train --seeds 11,12,13 \\
        --seconds 30 [--trace 1] [--out runs.jsonl]

``--workload`` takes several names separated by commas; each line of
``--out`` is one run: its workload, seed, exit code, seconds, result and
the end of its standard error."""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2) if q2 else float("nan")


def run_one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", workload,
                        "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                       capture_output=True, text=True)
    lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
    result = None
    if p.returncode == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode,
            "wall_s": time.perf_counter() - t0, "result": result, "stderr": p.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(Path(args.out), "a") if args.out else None
    for workload in args.workload.split(","):
        runs = []
        for seed in seeds:
            r = run_one(workload, seed, args.seconds, args.trace)
            runs.append(r)
            if out:
                out.write(json.dumps(r) + "\n")
                out.flush()
            res = r["result"] or {}
            print(json.dumps({"workload": workload, "seed": seed, "rc": r["rc"],
                              "wall_s": round(r["wall_s"], 1), "correct": res.get("correct"),
                              "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                              "checks": {k: v["value"] for k, v in res.get("checks", {}).items()},
                              "peak": res.get("device", {}).get("memory_peak_bytes")}), flush=True)
            if r["result"] is None:
                print(r["stderr"][-2000:], flush=True)
        names = sorted({k for r in runs if r["result"] for k in r["result"]["metrics"]})
        for name in names:
            vals = [r["result"]["metrics"][name]["value"] for r in runs
                    if r["result"] and name in r["result"]["metrics"]]
            print(f"{workload} {name}: median {statistics.median(vals)!r} "
                  f"spread {spread(vals)!r} n {len(vals)}", flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
