"""The persistent K3 and K6c against their staged sequences, on the CPU.

K3 (`gn_pcg`, csrc/gn_kernel.cu) and K6c (`cg_step`, csrc/cg_step.cu) each
run as one launch of a persistent kernel on a thread-block cluster, with a
cluster barrier where the staged sequences (`gn_factor` + `gn_cg`,
`cg_step_staged`) have a kernel boundary. Without a card, both sources are
built with g++ under the emulation of scripts/emulate_gn_kernel.py: a
cluster launch runs every thread of every CTA at once, `cluster.sync()` is
a barrier over all of them and `__syncthreads` one per CTA. At ~300 poses
the cluster has 2 CTAs; with the cluster capped at 2 CTAs, 600 poses make
CTA 0 walk two of the three 256-row blocks. Each case holds the persistent
kernels to their staged sequences with torch.equal (K3 at lam 0 and 1e-3,
with masked loop slots and on the chain alone; K6c on two ranks, without
and with Huber, the whole carry after 1 and 26 passes). Where the card
cannot place the cluster (the emulated occupancy query places none), K3
and K6c raise, and nothing falls back to the staged sequences.

The emulation runs in a subprocess with a timeout, so that a barrier that
not every thread reaches fails the test instead of hanging it.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the CPU emulation of the CUDA sources")


def _emulate(tmp_path, *args) -> dict:
    """The last JSON line of scripts/emulate_gn_kernel.py --persistent args."""
    cmd = [sys.executable, str(ROOT / "scripts" / "emulate_gn_kernel.py"), "--persistent",
           "--build-dir", str(tmp_path), *args]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the emulation did not end in {TIMEOUT_S} s: a barrier deadlock?")
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("poses,max_cluster", [(300, 0), (600, 2)],
                         ids=["2ctas", "ctas_walk_blocks"])
def test_persistent_kernels_equal_their_staged_sequences(gxx, tmp_path, poses, max_cluster):
    args = ["--poses", str(poses)] + (["--max-cluster", str(max_cluster)] if max_cluster else [])
    out = _emulate(tmp_path, *args)
    nb = -(-poses // 256)
    assert (out["poses"], out["blocks"]) == (poses, nb)
    assert out["ctas"] == min(nb, max_cluster or 16)
    checks = {k: v for k, v in out.items() if k.endswith(("_bitwise", "_finite"))}
    assert len(checks) == 12 and all(checks.values()), checks


def test_unplaceable_cluster_raises_without_fallback(gxx, tmp_path):
    out = _emulate(tmp_path, "--poses", "300", "--unplaceable")
    for name in ("k3", "k6c"):
        assert out[f"{name}_raised"] and "failed: CUDA error" in out[f"{name}_raised"], out
        assert out[f"{name}_staged_raised"] is None, out
