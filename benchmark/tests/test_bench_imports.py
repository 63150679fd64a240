"""Nothing a run loads is JAX or the JAX package (by top-level module
name), and the reference loads nothing of the program."""

import subprocess
import sys

from conftest import ROOT

RUN = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import small_cell
from benchmark import run
for name in ("bin.orbit", "bin.fit-all"):
    cell = small_cell(name)
    out = run.run_cell(cell, 5, 0.2, True, "cpu", t0=time.perf_counter())
    assert out["metrics"], name
print(run.forbidden_modules())
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.render
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"cpp_cuda_raytracer_dev_torch", "cpp_cuda_raytracer_dev_tpu",
                "jax", "jaxlib", "flax"}}))
"""


def _python(src: str) -> str:
    out = subprocess.run([sys.executable, "-c", src.format(
        root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    assert _python(RUN) == "[]"


def test_reference_loads_nothing_of_the_program():
    assert _python(REFERENCE) == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "cpp_cuda_raytracer_dev_tpu_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert run.forbidden_modules() == ["jaxlib"]
