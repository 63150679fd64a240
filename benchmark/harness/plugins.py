"""The benchmark's parts that later cells add as files of their own, found
by the name a configuration, a mix or ``BENCHMARK.json`` gives them:

- ``meshes/<generator>.py``: ``vertices(params) -> (T, 3, 3)`` float32, a
  configuration's ``mesh`` entry being ``params``;
- ``accels/<builder>.py``: ``build(params, vertices, tris)``, the
  program's acceleration structure over a configuration's mesh;
- ``kinds/<kind>.py``: ``run(run)`` and ``control(run)`` of a traffic
  mix's kind, with the generator that reads its mixes;
- ``metrics/<metric>.py``: ``read(trace)``, a per-layer metric."""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def load(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under the benchmark's folder."""
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder[:-1]} {name!r}: {path} is missing")
    mod_name = f"benchmark.{folder}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return mod
