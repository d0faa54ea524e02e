"""A run whose timed path is broken comes out not correct: the harness's
look for a card is skipped, the rest of the run is driven at a tiny size on
the CPU with each fault its cell can have planted in the port. The same run
unbroken comes out correct. (One card: no exchange between chips to leave
out.)"""
import pytest

from benchmarks import faults
from benchmarks.harness.main import run_cell
from benchmarks.tests.conftest import tiny_files

SEED = 2 ** 34 + 7
CASES = [("sig3d.train", None), ("sig3d.train", "stale_state"), ("sig3d.train", "half_batch"),
         ("sig3d.train", "drop_map_entries"),
         ("sig3d.answer.full_forward", None), ("sig3d.answer.full_forward", "alter_answer"),
         ("sig3d.answer.full_forward", "drop_map_entries"),
         ("sig3d.answer.scene_cache", None), ("sig3d.answer.scene_cache", "alter_answer"),
         ("sig3d.answer.scene_cache", "drop_map_entries"),
         ("blip2_flant5xl.answer", None), ("blip2_flant5xl.answer", "alter_token")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault):
    with faults.planted(fault):
        result = run_cell(workload, SEED, 0.3, False, "cpu", files=tiny_files(workload))
    assert result["correct"] is (fault is None), result["checks"]
