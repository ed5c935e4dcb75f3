"""Find a cell's parts by name, as files of their own under benchmark/.

configs/<config>.json     a map: its generator and sizes, the deployment
traffic/<traffic>.json    a mix: the entry it drives, that entry's
                          parameters and the reference's
cells/<cell>.json         a cell's limits on the numbers compared
generators/<name>.py      makes a map from a seed (a config names it)
entries/<name>.py         one request into the program (a mix names it)
end_to_end/<metric>.py    reads an end-to-end metric from a run
layer_metrics/<metric>.py reads a per-layer metric from a traced run
Adding a cell, a config, a mix or a metric adds files and BENCHMARK.json
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("configs", "traffic", "cells", "generators", "entries", "end_to_end", "layer_metrics")


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def path(kind: str, name: str, root: Path = ROOT) -> Path:
    if kind not in KINDS:
        raise ValueError(kind)
    suffix = ".json" if kind in ("configs", "traffic", "cells") else ".py"
    p = root / "benchmark" / kind / f"{name}{suffix}"
    if not p.is_file():
        raise FileNotFoundError(f"{p} (the {kind[:-1] if kind.endswith('s') else kind} {name!r})")
    return p


def data(kind: str, name: str, root: Path = ROOT) -> dict:
    return json.loads(path(kind, name, root).read_text())


def module(kind: str, name: str, root: Path = ROOT):
    """The module in benchmark/<kind>/<name>.py (names may hold dots)."""
    p = path(kind, name, root)
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, kind: str, cell_name: str) -> list:
    """The names of the `end_to_end` or `per_layer` metrics a cell reports."""
    return [m["name"] for m in spec[kind] if cell_name in m.get("workloads", [cell_name])]
