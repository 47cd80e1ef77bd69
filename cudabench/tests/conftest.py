"""Put the checkout's ``src`` and root on the path for the harness's
tests (they run from the root: ``python -m pytest cudabench/tests``)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import json  # noqa: E402

import pytest  # noqa: E402

from cudabench import cells  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL_MIX = {
    "colony_loop": {"driver": "colony_loop", "n": 64, "setup_iterations": 2},
    "poisson": {"driver": "poisson", "rate": 6.0, "min_n": 40, "max_n": 64,
                "iterations": 4, "box": 1000.0, "warmup_s": 0.5,
                "drain_s": 20.0, "check_sample": 3},
}


def small_cell(name: str) -> cells.Cell:
    """Cell ``name`` of BENCHMARK.json with its mix cut to a CPU test's
    size (its configuration, driver and metric readers as they are)."""
    cell = cells.load(ROOT, name)
    small = SMALL_MIX[cell.traffic["driver"]]
    cell.traffic = dict(cell.traffic, **small)
    if cell.traffic.get("restart_every"):
        cell.traffic["restart_every"] = 3
    if "iterations" in cell.config.get("aco", {}):
        cell.config = json.loads(json.dumps(cell.config))
        cell.config["aco"]["iterations"] = cell.traffic["iterations"]
    return cell


@pytest.fixture(params=[w["name"] for w in BENCH["workloads"]])
def small(request):
    return small_cell(request.param)
