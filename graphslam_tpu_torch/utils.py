"""Observability: timers, counters, device sync, the card's name, and
profiler traces; port of graphslam_tpu/utils.py.

Accumulating wall-clock timers around pipeline stages and event counters
(keyframes, loop closures, solves) replace the reference's commented-out
ROS_INFO trace points.
"""

from __future__ import annotations

import contextlib
import logging
import subprocess
import time
from collections import defaultdict
from typing import Dict

import torch

logger = logging.getLogger("graphslam_tpu_torch")


def sync(x):
    """Wait for the device work behind tensor x (torch.cuda.synchronize for a
    CUDA tensor; CPU work is already done). Returns x."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x


class Stopwatch:
    """Accumulating per-stage timers: `with sw.time("solve"): ...`. Given
    `sync_tree`, a tensor, the timer waits for the device work behind it
    (`sync`) before it stops."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync_tree=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_tree is not None:
                sync(sync_tree)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.total[k],
                "count": self.count[k],
                "mean_ms": 1e3 * self.total[k] / max(self.count[k], 1),
            }
            for k in sorted(self.total)
        }

    def log_summary(self):
        for k, v in self.summary().items():
            logger.info(
                "%-20s %6d calls  %8.2f ms/call  %8.3f s total",
                k, v["count"], v["mean_ms"], v["total_s"],
            )


class Counters:
    """SLAM event counters (the ROS_INFO tallies, queryable)."""

    def __init__(self):
        self.values: Dict[str, int] = defaultdict(int)

    def bump(self, name: str, by: int = 1):
        self.values[name] += by

    def as_dict(self) -> Dict[str, int]:
        return dict(self.values)


def device_info() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (one line per card). Raises if nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a torch.profiler trace (TensorBoard format, the card's
    kernels too when CUDA is available) around a block, into logdir."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield
