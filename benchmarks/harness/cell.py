"""What every driver shares: a cell's files, the port's configuration built
from them, the closed-loop window, the checks and their limits."""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(workload: str, man: Optional[dict] = None) -> dict:
    """The cell's entry, configuration file and traffic mix, by name."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; one of {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    limits = BENCH / "limits" / f"{workload}.json"
    return {"cell": w, "config": load_json(ROOT / cfg_entry["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(limits)["limits"] if limits.exists() else {}}


def set_dotted(obj, key: str, value) -> None:
    """``obj.a.b = value`` for ``key = "a.b"``; lists become tuples where the
    field holds a tuple."""
    *path, leaf = key.split(".")
    for p in path:
        obj = getattr(obj, p)
    if not hasattr(obj, leaf):
        raise KeyError(f"{type(obj).__name__} has no field {leaf!r} ({key})")
    if isinstance(value, list) and isinstance(getattr(obj, leaf), tuple):
        value = tuple(value)
    setattr(obj, leaf, value)


@dataclass
class Check:
    """One number compared with its limit; ``ok`` when it is no larger."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Window:
    """What a closed loop completed in its window."""
    units: float = 0.0                   # samples or questions completed
    attempted: float = 0.0
    failed: float = 0.0
    seconds: float = 0.0
    latencies_s: List[float] = field(default_factory=list)   # one per question


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(seconds: float, body, device) -> Window:
    """Call ``body(i, window)`` until ``seconds`` have passed; each call runs
    one batch and records its work in ``window``. The window closes when
    the last batch's work is done."""
    win = Window()
    sync(device)
    t0 = time.perf_counter()
    i = 0
    while True:
        body(i, win)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    win.seconds = time.perf_counter() - t0
    return win

