"""The control: the reference in TF32 put in the program's place fails at
least one of each cell's numbers, on three seeds (``--control``; PERF.md
gives its readings) — on the card at the cells' own sizes, and on the CPU
at a cut size."""

import json

import pytest

from conftest import ROOT, small_cell

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [101, 2**31 + 7, 998877665])
def test_control_fails_the_check(cell, seed, cuda):
    import time

    from benchmark import run
    from benchmark.harness import cells, check
    c = cells.load(cell)
    out = run.run_cell(c, seed, 1.0, False, "cuda", t0=time.perf_counter(),
                       control=True)
    ok, judged = check.judge(out["control"], c.limits)
    assert not ok, judged


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check_at_a_cut_size(cell):
    import time

    from benchmark import run
    from benchmark.harness import check
    c = small_cell(cell)
    out = run.run_cell(c, 5, 0.1, False, "cpu", t0=time.perf_counter(),
                       control=True)
    ok, judged = check.judge(out["control"], c.limits)
    assert not ok, judged
