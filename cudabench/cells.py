"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

A cell (one entry of ``workloads``) names a configuration and a traffic
mix; the configuration's file is the one its ``configs`` entry gives, the
mix is ``workloads/<traffic>.json``, its driver ``traffic/<driver>.py``,
and each per-layer metric that the cell reports is read by
``metrics/<metric>.py``.  Adding a cell or a metric adds files and
entries; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file
    traffic: dict           # the traffic mix's file
    driver: ModuleType      # traffic/<driver>.py
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list         # (entry, reader module) this cell reports


def load_module(path: Path) -> ModuleType:
    """Import a file by path (metric names hold dots, so not by name)."""
    spec = importlib.util.spec_from_file_location(
        f"cudabench._loaded.{path.parent.name}.{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, name: str, bench: Optional[dict] = None,
         base: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``), its
    files read from ``base`` (this package's folder)."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((base / "workloads" / f"{w['traffic']}.json")
                         .read_text())
    driver = load_module(base / "traffic" / f"{traffic['driver']}.py")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [(m, load_module(base / "metrics" / f"{m['name']}.py"))
                 for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in e2e_names]
    return Cell(name, int(w["chips"]), config, traffic, driver, e2e,
                per_layer)
