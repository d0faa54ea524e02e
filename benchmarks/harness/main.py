"""One run of one cell: set-up, the measured window, the per-layer
readings (``--trace 1``), the check against the reference, the result line.

Standard output ends with one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), and
last ``checks``: each number compared with its limit. The same numbers end
standard error, one a line."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, Optional

import torch

from benchmarks.harness.cell import BENCH, Check, cell_files, manifest
from benchmarks.harness.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "situation3d_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's, Optax's or the
    JAX package's (whole names: ``situation3d_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def driver_for(files: dict, seed: int, device):
    """The driver of the cell's model and its traffic's task, by name."""
    name = f"{files['config']['model']}_{files['traffic']['task']}"
    return importlib.import_module(f"benchmarks.drivers.{name}").Driver(files, seed, device)


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """``benchmarks/metrics/<name>.py``'s ``read(ctx)``; None when it finds
    nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmarks.metrics.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(ctx)
    return None if value is None or not math.isfinite(value) else float(value)


def _listed(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    # ``count`` is the cards the run uses; ``device_count`` those the machine shows
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "device_count": torch.cuda.device_count(),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> Optional[str]:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, files: Optional[dict] = None) -> dict:
    """The run; returns the result object (not printed). ``files`` replaces
    the cell's files (tests shrink a cell through it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest()
    files = files or cell_files(workload, man)
    drv = driver_for(files, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(trace, every=files["traffic"].get("trace_every", 4))
    with tracer:
        win = drv.window(seconds, tracer)
    info = device_info(device)
    result: Dict = {"attempted": int(win.attempted), "failed": int(win.failed)}
    metrics: Dict[str, dict] = {}
    if not trace:
        values = dict(drv.end_to_end(win), setup_s=setup_s)
        for m in man["end_to_end"]:
            if _listed(m, workload):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        s = tracer.summary
        ctx = drv.layer_context(win, s)
        for m in man["per_layer"]:
            if _listed(m, workload):
                v = read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        info["busy_s"] = s.busy_s
        info["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": s.top(s.device_ops), "idle_gaps": s.top(s.idle_gaps)}
    info["power_limit"] = power_limit() if info["platform"] == "gpu" else None
    readings = drv.readings()
    limits = files.get("limits") or {}
    checks = [Check(n, float(v), float(limits.get(n, float("nan")))) for n, v in readings.items()]
    result["correct"] = bool(checks) and all(c.ok for c in checks) and win.failed == 0
    result["metrics"] = metrics
    result["device"] = info
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = {w["name"]: w for w in manifest()["workloads"]}[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def fixed_cache_dirs(root) -> None:
    """Kernel caches of anything the program might compile, at fixed paths
    inside the checkout."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
