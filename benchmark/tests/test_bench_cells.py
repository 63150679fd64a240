"""Configurations, cells, limits and metric readers load by name."""

import json

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    from benchmark.harness import cells
    c = cells.load(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"]
    from benchmark.harness import plugins
    kind = plugins.load("kinds", c.traffic["kind"])
    assert callable(kind.run) and callable(kind.control)
    assert c.chips == 1
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    # every number the check compares has a limit between its readings
    for name, lim in c.limits.items():
        assert lim["lower"] < lim["limit"] < lim["upper"], name


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_file_matches_entry(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert config["file"] == f"benchmark/configs/{config['name']}.json"


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_parts_load_by_name(config):
    """A configuration names its mesh generator, its acceleration
    structure's builder, the program's RenderConfig whole and the kernel
    sources it runs; each is found by name, with no code of its own."""
    from benchmark.harness import plugins
    from cpp_cuda_raytracer_dev_torch import RenderConfig
    data = json.loads((ROOT / config["file"]).read_text())
    assert callable(plugins.load("meshes",
                                 data["mesh"]["generator"]).vertices)
    if data["accel"]:
        assert callable(plugins.load("accels", data["accel"]["builder"]).build)
    assert RenderConfig(**data["render"]).method == data["render"]["method"]
    csrc = ROOT / "cpp_cuda_raytracer_dev_torch" / "csrc"
    for name in data["kernel_sources"]:
        assert (csrc / f"{name}.cu").is_file(), name


def test_unknown_part_raises():
    from benchmark.harness import plugins
    with pytest.raises(KeyError):
        plugins.load("meshes", "no_such_mesh")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_exists(metric):
    from benchmark.harness import trace
    assert callable(trace.reader(metric["name"]))
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in ends


def test_unknown_cell_raises():
    from benchmark.harness import cells
    with pytest.raises(KeyError):
        cells.load("no.such.cell")
