"""Shared set-up of the benchmark's own tests (CPU; those marked ``gpu``
skip themselves where there is no card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips itself where there is none")


def small_cell(name: str, tris: int = 2000, expect: int = 2024,
               res=(64, 36)):
    """The cell ``name`` cut to a mesh of ``tris`` triangles at ``res`` and
    to a few frames or steps, with its own limits."""
    from benchmark.harness import cells
    cell = cells.load(name)
    cell.config["mesh"].update(triangles=tris, expect_triangles=expect)
    cell.config["camera"].update(res_w=res[0], res_h=res[1])
    t = cell.traffic
    if t["kind"] == "serve":
        t.update(script=[["W", 2], ["R", 2], ["Q", 1], ["T", 2], ["E", 1],
                         ["S", 2], ["R", 1], ["T", 1]],
                 check_frames=2)
    else:
        t.update(warmup_steps=1, trace_steps=2)
    return cell


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
