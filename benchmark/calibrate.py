"""Readings for the limits of a cell's comparison, on the card at the cell's
own size: the program's numbers over many seeds (the lower readings) and
the control's over a few (the upper readings). The benchmark's own runs do
not run this.

    python benchmark/calibrate.py --workload m3500.schur --seeds 1-12 \
        --control-seeds 101-103 --seconds 2 [--out FILE]

The control is the reference put in the program's place, computed in the
mix's `control` precision (reference/precision.py): its poses, cost and
accepted steps are judged as an answer of the program would be. Prints a
JSON line a seed and, last, each number's largest program reading and
smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(name: str, seed: int, device, root: Path = ROOT,
                    overrides: dict | None = None, precision: str | None = None) -> dict:
    """The numbers of the control's answer on the map of `seed` (or, with
    `precision`, of the reference computed in that precision)."""
    from benchmark import judge, specs
    from benchmark.reference import solve as reference

    overrides = overrides or {}
    w = specs.cell(specs.benchmark(root), name)
    cfg = {**specs.data("configs", w["config"], root), **overrides.get("configs", {})}
    mix = {**specs.data("traffic", w["traffic"], root), **overrides.get("traffic", {})}
    data = specs.module("generators", cfg["generator"], root).make(cfg, seed)
    ref = reference.solve(data, mix["reference"], device)
    ctrl = reference.solve(data, mix["reference"], device, precision=precision or mix["control"])
    answer = {"poses": ctrl["poses"]}
    if mix["reference"]["method"] == "lm":
        answer.update(error=ctrl["cost"], accepted=ctrl["accepted"])
    huber = mix["reference"].get("huber")
    return judge.numbers(answer, ref, lambda x: reference.cost_at(data, x, huber, device))


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--witness-seeds", default="",
                    help="seeds on which the reference computed in float32 is judged")
    ap.add_argument("--program-device", default=None,
                    help="run the program there (the reference stays on --device)")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    from benchmark import run

    rows, lower, upper = [], {}, {}
    for seed in _seeds(a.seeds) if a.seeds else []:
        d = {}
        out = run.run_cell(a.workload, seed, a.seconds, False, a.program_device or a.device,
                           t0=time.perf_counter(), details=d, reference_device=a.device)
        row = {"seed": seed, "side": "program", "device": a.program_device or a.device,
               "correct": out["correct"],
               "attempted": out["attempted"], "numbers": d["numbers"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        for k, v in d["numbers"].items():
            lower[k] = max(lower.get(k, v), v)
        rows.append(row)
        print(json.dumps(row), flush=True)
    for seed in _seeds(a.control_seeds) if a.control_seeds else []:
        nums = control_numbers(a.workload, seed, a.device)
        for k, v in nums.items():
            upper[k] = min(upper.get(k, v), v)
        row = {"seed": seed, "side": "control", "numbers": nums}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for seed in _seeds(a.witness_seeds) if a.witness_seeds else []:
        nums = control_numbers(a.workload, seed, a.device, precision="float32")
        row = {"seed": seed, "side": "reference in float32", "numbers": nums}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": a.workload, "lower": lower, "upper": upper}
    print(json.dumps(summary), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(json.dumps(r) for r in rows + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
