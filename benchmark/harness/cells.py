"""A cell by name: its entry in ``BENCHMARK.json``, its configuration file
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), its
limits (``limits/<cell>.json``) and the metrics it reports."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict            # number compared -> {"limit": ..., ...}
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: the repository's
    ``BENCHMARK.json``)."""
    if bench is None:
        bench = _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = _json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    traffic = _json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits_file = BENCH_DIR / "limits" / f"{name}.json"
    limits = _json(limits_file) if limits_file.exists() else {}
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])
