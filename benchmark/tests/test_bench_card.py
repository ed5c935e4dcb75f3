"""Every cell on the card through the benchmark's command: a short window, exit 0,
`correct` true. Marked `cuda`: skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import specs


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in specs.benchmark()["workloads"]])
def test_the_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=specs.ROOT, timeout=1500)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
