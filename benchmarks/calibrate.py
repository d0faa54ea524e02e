"""The readings that a cell's limits are set from, many seeds in one
process: for each seed the program's numbers after a short window at the
cell's own load, and on the control seeds the same numbers with the
reference computed in a lower precision put in the program's place
(``reference/precision.py:Fp8``), or with a fault planted in the timed
path (``benchmarks/faults.py``).

    python3 -m benchmarks.calibrate --workload sig3d.train --seeds 1,2,3 \\
        --seconds 2 [--control 4,5,6] [--fault half_batch --fault-seeds 7,8,9] \\
        [--out calibrate.jsonl]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmarks import faults
from benchmarks.harness.cell import cell_files
from benchmarks.harness.main import driver_for
from benchmarks.harness.trace import Tracer


def reading(workload: str, seed: int, seconds: float, mode: str, fault: str = None) -> dict:
    files = cell_files(workload)
    drv = driver_for(files, seed, "cuda:0")
    t0 = time.perf_counter()
    with faults.planted(fault):
        drv.setup()
        win = drv.window(seconds, Tracer(False))
    values = (drv.readings() if mode == "program"
              else drv.readings(precision="fp8_e4m3", program=False))
    out = {"workload": workload, "seed": seed, "mode": mode, "fault": fault,
           "units": win.units, "seconds": round(time.perf_counter() - t0, 1), "readings": values}
    del drv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    todo = [(int(s), "program", None) for s in args.seeds.split(",") if s]
    todo += [(int(s), "control", None) for s in args.control.split(",") if s]
    todo += [(int(s), "program", args.fault) for s in args.fault_seeds.split(",") if s]
    for seed, mode, fault in todo:
        r = reading(args.workload, seed, args.seconds, mode, fault)
        print(json.dumps(r), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
