"""BENCHMARK.json keeps to the contract, and every cell finds its parts by name."""

import json
import re
import shutil

import pytest

from benchmark import run, specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    spec = specs.benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert json.loads((specs.ROOT / c["file"]).read_text())["name"] == c["name"]
    cells = [w["name"] for w in spec["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for c in m.get("workloads", cells):
            assert m["moves"] in specs.metrics_of(spec, "end_to_end", c)
    for c in cells:
        e = specs.metrics_of(spec, "end_to_end", c)
        assert "setup_s" in e and len(e) >= 2 and specs.metrics_of(spec, "per_layer", c)


def _parts(spec: dict, cell_name: str, root=specs.ROOT) -> dict:
    """Every file a cell needs, by kind (raises where one is missing)."""
    w = specs.cell(spec, cell_name)
    cfg = specs.data("configs", w["config"], root)
    mix = specs.data("traffic", w["traffic"], root)
    return {
        "configs": specs.path("configs", w["config"], root),
        "traffic": specs.path("traffic", w["traffic"], root),
        "cells": specs.path("cells", cell_name, root),
        "generators": specs.path("generators", cfg["generator"], root),
        "entries": specs.path("entries", mix["entry"], root),
        "end_to_end": [specs.path("end_to_end", m, root)
                       for m in specs.metrics_of(spec, "end_to_end", cell_name)],
        "layer_metrics": [specs.path("layer_metrics", m, root)
                          for m in specs.metrics_of(spec, "per_layer", cell_name)],
    }


@pytest.mark.parametrize("cell", [w["name"] for w in specs.benchmark()["workloads"]])
def test_every_cell_resolves_by_name(cell):
    parts = _parts(specs.benchmark(), cell)
    for kind, p in parts.items():
        for f in (p if isinstance(p, list) else [p]):
            assert f.is_file() and f.parent.name == kind
    limits = specs.data("cells", cell)["limits"]
    assert limits and all(v >= 0 for v in limits.values())


def test_a_cell_of_added_files_is_found_and_runs(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric added as files
    and BENCHMARK.json entries, nothing edited."""
    shutil.copytree(specs.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = specs.benchmark()
    cfg = specs.data("configs", "m3500")
    cfg.update(name="m120", n_poses=120)
    (tmp_path / "benchmark/configs/m120.json").write_text(json.dumps(cfg))
    mix = specs.data("traffic", "gn")
    mix.update(iterations=4, reference={**mix["reference"], "iterations": 4})
    (tmp_path / "benchmark/traffic/gn4.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/cells/m120.gn4.json").write_text(json.dumps({"limits": {"cost_gap": 0.1}}))
    (tmp_path / "benchmark/layer_metrics/requests_n.py").write_text(
        "def read(run):\n    return float(len(run.latencies))\n")
    spec["configs"].append({"name": "m120", "source": "a test", "file": "benchmark/configs/m120.json",
                            "reduced": ["n_poses"], "why": "a test"})
    spec["workloads"].append({"name": "m120.gn4", "config": "m120", "traffic": "gn4", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "requests_n", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "device", "moves": "solves_per_s",
                              "workloads": ["m120.gn4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    parts = _parts(specs.benchmark(tmp_path), "m120.gn4", tmp_path)
    assert parts["traffic"] == tmp_path / "benchmark/traffic/gn4.json"
    out = run.run_cell("m120.gn4", 5, 0.2, True, "cpu", root=tmp_path)
    assert out["correct"] and out["metrics"]["requests_n"]["value"] == out["attempted"]
