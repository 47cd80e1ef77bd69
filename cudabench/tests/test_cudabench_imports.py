"""Nothing the benchmark runs loads ``jax`` or the JAX package."""
import subprocess
import sys

from cudabench import run

CHECK = """
import sys
sys.path.insert(0, "src")
from cudabench import cells, run, control, sweep
from cudabench.reference import aco
import json
bench = json.load(open("BENCHMARK.json"))
for w in bench["workloads"]:
    cell = cells.load(run.ROOT, w["name"])
    import repro_torch.solver.streaming, repro_torch.solver.programs
print(run.forbidden_modules())
"""


def test_forbidden_names_compare_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core"]) == []
    assert run.forbidden_modules(["repro.core"]) == ["repro.core"]
    assert run.forbidden_modules(["jax", "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib.xla"]
    assert run.forbidden_modules(["jaxtyping", "reprox"]) == []


def test_the_harness_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
