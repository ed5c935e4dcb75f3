"""A run's last line: the contract's keys, the cell's metrics, `checks` last.
The harness runs here on the CPU at a small size, the card check skipped."""

import json
import subprocess
import sys

import pytest

from benchmark import run, specs
from benchmark.tests._small import CELLS, small

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_the_result_line(cell, trace):
    out = run.run_cell(cell, 2**31 + 11, 0.3, bool(trace), "cpu", overrides=small(cell))
    line = json.loads(json.dumps(out))
    keys = KEYS[:-1] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    spec = specs.benchmark()
    want = specs.metrics_of(spec, "per_layer" if trace else "end_to_end", cell)
    units = {m["name"]: m["unit"] for m in spec["per_layer"] + spec["end_to_end"]}
    # device metrics have nothing to read on the CPU; the rest are there
    assert set(line["metrics"]) == {m for m in want if m not in
                                    ("device_idle_pct", "k1lm_roofline", "k4_roofline")}
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0
    assert set(line["checks"]) == set(specs.data("cells", cell)["limits"])
    for v in line["checks"].values():
        assert v["value"] <= v["limit"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert line["device"]["window_s"] > 0 and set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command prints no result and fails."""
    p = subprocess.run([sys.executable, str(specs.ROOT / "benchmark/run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
