"""Reduce a torch.profiler trace of the window to device time.

The trace is read from the profiler's own Chrome-trace export (written to
TMPDIR and deleted), which costs seconds where building the profiler's
Python events for a window of tens of thousands of launches costs minutes.
Every device record (a kernel, a copy, a set) is an interval on the card's
timeline; their union is the busy time. Kernel time is summed by the name
the profiler gives. An idle stretch of the card inside the window is named
by the innermost host span ("bench.<name>", recorder.py) running at its
middle.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def events(prof) -> list:
    """The trace's complete events ("ph": "X")."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def reduce(prof, top: int = 10) -> dict:
    """{"busy_s", "window_s", "kernels": {name: [count, seconds]},
    "device_ops": [[name, seconds]] (most time first), "idle_gaps":
    [[host span, seconds]] (most idle time first)}. The window is the
    host's "bench.window" span."""
    evs = events(prof)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][6:]) for e in evs
             if e.get("cat") == "user_annotation" and e["name"].startswith("bench.")]
    window = [s for s in spans if s[2] == "window"]
    if not window:
        raise RuntimeError("the trace has no bench.window span")
    w0, w1, _ = window[0]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in evs
                 if e.get("cat") in DEVICE and float(e["dur"]) > 0)
    kernels = defaultdict(lambda: [0, 0.0])
    busy, gaps, cursor = 0.0, [], w0
    for s, t, name in dev:
        kernels[name][0] += 1
        kernels[name][1] += (t - s) / 1e6
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps.append((cursor, w1))
    inner = sorted((s for s in spans if s[2] != "window"), key=lambda a: a[1] - a[0])
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        name = next((n for s, t, n in inner if s <= mid <= t), "between requests")
        idle[name] += (b - a) / 1e6
    ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda a: -a[1])
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": dict(kernels),
        "device_ops": [[n[:120], s] for n, s in ops[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda a: -a[1])[:top]],
    }
