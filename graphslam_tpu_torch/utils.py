"""Device helpers: synchronize, name the card a number was taken on, and
capture a profiler trace."""

from __future__ import annotations

import contextlib
import subprocess

import torch


def sync(x):
    """Wait for the device work behind tensor x (torch.cuda.synchronize for a
    CUDA tensor; CPU work is already done). Returns x."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x


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
