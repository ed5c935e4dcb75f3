"""Run one cell of BENCHMARK.json on this machine's card and print its result.

    python benchmark/run.py --workload m3500.lm-huber --seed 7 --seconds 20 --trace 0

A run makes the cell's map from the seed, sets up the program and warms it
with requests of the cell's own shapes (set-up), then sends requests back
to back from one client for --seconds (the window), then judges every
answer against the plain reference (benchmark/reference/) solving the same
map. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics, or with
--trace 1 the per-layer ones read from a torch.profiler trace of the
window's first TRACE_SECONDS), `device`, with --trace 1 `breakdown`, and last `checks`: each
number compared beside its limit, which are also the last lines of
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

# One client in one process: no math library's thread pool competes with it
# for the host's cores (set before numpy and torch load them).
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "graphslam_tpu")
# A traced run's profiler records the window's first TRACE_SECONDS (the
# requests that start in them); the window then runs on untraced. The
# export of a trace takes host seconds for each traced second.
TRACE_SECONDS = 20.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def chain_length(edges) -> int:
    """The longest run of (k, k+1) edges from pose 0: the odometry chain."""
    have = {(int(i), int(j)) for i, j in edges}
    c = 0
    while (c, c + 1) in have:
        c += 1
    return c


def leaked_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _card_state() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,clocks.sm,power.draw,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, root: Path = ROOT,
             t0: float = T0, overrides: dict | None = None, reference_device=None,
             details: dict | None = None) -> dict:
    """One run of the cell `name`; returns the result object. `overrides`
    ({"configs": {...}, "traffic": {...}}) changes the config's and the
    mix's entries (the tests' small maps); `reference_device` is where the
    reference solves (the run's device by default); `details`, where
    given, receives every number of the comparison (the worst answer's)."""
    import numpy as np
    import torch

    from benchmark import devtrace, judge, specs
    from benchmark.recorder import Recorder
    from benchmark.reference import solve as reference

    overrides = overrides or {}
    spec = specs.benchmark(root)
    w = specs.cell(spec, name)
    cfg = {**specs.data("configs", w["config"], root), **overrides.get("configs", {})}
    mix = {**specs.data("traffic", w["traffic"], root), **overrides.get("traffic", {})}
    limits = specs.data("cells", name, root)["limits"]
    device = torch.device(device)

    marks = [("imports", time.perf_counter())]
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        marks.append(("CUDA context", time.perf_counter()))
    data = specs.module("generators", cfg["generator"], root).make(cfg, seed)
    marks.append(("map", time.perf_counter()))
    entry = specs.module("entries", mix["entry"], root)
    state = entry.setup(mix, data, device)
    marks.append(("entry set-up", time.perf_counter()))
    for k in range(int(mix.get("warmup", 2))):
        entry.request(state, data, Recorder(device, False))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append((f"warm request {k + 1}", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    parts = ", ".join(f"{n} {b - a:.3f}" for (_, a), (n, b) in zip([("start", t0)] + marks, marks))
    log(f"set-up parts (s): {parts}")
    log(f"set-up {setup_s:.3f} s: {cfg['name']} ({data['poses'].shape[0]} poses, "
        f"{len(data['edges'])} edges), mix {w['traffic']} through entries/{mix['entry']}.py")

    rec = Recorder(device, trace)
    answers, latencies = [], []
    traced = traced_s = None  # the requests in the traced part of the window, its length
    with contextlib.ExitStack() as stack:
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(torch.profiler.record_function("bench.window"))
        start = time.perf_counter()
        while True:
            a = time.perf_counter()
            answers.append(entry.request(state, data, rec))
            b = time.perf_counter()
            latencies.append(b - a)
            if trace and traced is None and b - start >= min(seconds, TRACE_SECONDS):
                stack.close()
                traced, traced_s, rec.trace = len(latencies), b - start, False
            if b - start >= seconds:
                break
    window_s = b - start
    dev = _card(torch, device)
    del state
    gc.collect()
    tr = devtrace.reduce(prof) if prof is not None else None
    prof = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
        log(f"card: {_card_state()}")
    q = len(latencies) // 4 or 1
    ms = [1e3 * np.median(part) for part in (latencies[:q], latencies, latencies[-q:])]
    log(f"window {window_s:.3f} s, {len(latencies)} requests; median request {ms[1]:.3f} ms "
        f"(first quarter {ms[0]:.3f}, last quarter {ms[2]:.3f})"
        + (f"; the first {traced} traced, {traced_s:.3f} s" if trace else ""))

    # The reference, once the window has closed and the program's state is gone.
    rdev = torch.device(reference_device) if reference_device is not None else device
    r0 = time.perf_counter()
    ref = reference.solve(data, mix["reference"], rdev)
    huber = mix["reference"].get("huber")
    seen, worst, failed = {}, {}, 0
    for ans in answers:
        d = judge.digest(ans)
        if d not in seen:
            seen[d] = judge.numbers(ans, ref, lambda x: reference.cost_at(data, x, huber, rdev))
        nums = seen[d]
        failed += 0 if judge.within(nums, limits) else 1
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    log(f"reference {time.perf_counter() - r0:.3f} s: cost {ref['cost']:.6f}, accepted "
        f"{ref['accepted']}; {len(seen)} distinct answers of {len(answers)}; ATE of the "
        f"reference {reference.ate(ref['poses'], data['gt'], data['poses'].shape[-1]):.6f} m")
    for k in sorted(worst):
        if k not in limits:
            log(f"  {k}: {worst[k]!r} (not compared)")

    edges = np.asarray(data["edges"])
    c = chain_length(edges)
    # What the metrics read: the whole window, or in a traced run its traced part.
    run = types.SimpleNamespace(
        cell=w, config=cfg, mix=mix, seed=seed, setup_s=setup_s,
        window_s=traced_s if trace else window_s, latencies=latencies[:traced],
        spans={k: v[:traced] for k, v in rec.spans.items()}, stages=dict(rec.stages), trace=tr,
        shape=(int(data["poses"].shape[0]), c, int(len(edges) - c)))
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in spec[kind]}
    metrics = {}
    for m in specs.metrics_of(spec, kind, name):
        v = specs.module("layer_metrics" if trace else "end_to_end", m, root).read(run)
        if v is None:
            log(f"  {m}: nothing to read; left out")
            continue
        metrics[m] = {"value": float(v), "unit": units[m]}
    if details is not None:
        details.update(numbers=worst, reference_cost=ref["cost"], distinct=len(seen))
    checks = {k: {"value": worst.get(k, float("inf")), "limit": lim} for k, lim in limits.items()}
    out = {"correct": bool(answers) and failed == 0, "attempted": len(answers), "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from benchmark import specs

    w = specs.cell(specs.benchmark(ROOT), a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{a.workload} needs {w['chips']} CUDA card(s); this machine has {n}")
        return 3
    torch.set_num_threads(1)
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    found = leaked_modules()
    if found:
        log(f"the run loaded {found}: the benchmark may not import JAX or the JAX package")
        return 4
    for k, v in out["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
