"""``python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json`` on the CUDA card
(see ``harness/main.py``)."""
import time

_T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _main() -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks.harness.main import fixed_cache_dirs, main
    fixed_cache_dirs(ROOT)
    return main(t_start=_T0)


if __name__ == "__main__":
    sys.exit(_main())
