"""Every cell loads from its files, and a new cell or metric is only new
files and entries."""
import json
import shutil

import pytest

from cudabench import cells, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_its_files(name):
    cell = cells.load(run.ROOT, name)
    assert hasattr(cell.driver, "Session")
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for spec, reader in cell.per_layer:
        assert spec["moves"] in names
        assert callable(reader.read)


def test_names_and_files_follow_the_contract():
    for c in BENCH["configs"]:
        assert c["file"].startswith("cudabench/")
        assert (run.ROOT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert (run.ROOT / "cudabench" / "metrics" / f"{m['name']}.py"
                ).is_file()
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


def test_a_cell_and_a_metric_are_new_files_only(tmp_path):
    base = tmp_path / "cudabench"
    shutil.copytree(run.ROOT / "cudabench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (base / "workloads" / "n100.json").write_text(json.dumps(
        {"driver": "colony_loop", "n": 100}))
    (base / "metrics" / "walk_launches.colony.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "as-colony.n100",
                               "config": "as-colony", "traffic": "n100",
                               "chips": 1, "why": "a small colony"})
    bench["per_layer"].append({
        "name": "walk_launches.colony", "unit": "1", "better": "lower",
        "source": "device_trace", "layer": "kernels", "moves": "iter_ms",
        "workloads": ["as-colony.n100"]})
    for m in bench["end_to_end"]:
        if m["name"] == "iter_ms":
            m["workloads"].append("as-colony.n100")
    cell = cells.load(run.ROOT, "as-colony.n100", bench=bench, base=base)
    assert cell.traffic["n"] == 100
    assert [s["name"] for s, _ in cell.per_layer] == ["walk_launches.colony"]
    assert cell.per_layer[0][1].read({}) == 1.0
