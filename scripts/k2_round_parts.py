#!/usr/bin/env python3
"""What one IRLS round of K2's one-launch loop (csrc/icp_kernel.cu,
`k_icp_rounds`) spends its time on, on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 scripts/k2_round_parts.py

Builds copies of csrc/icp_kernel.cu under graphslam_tpu_torch/build/parts/,
each with one part of the round cut out (the results are then wrong: these
copies only time), and times `icp_match` of each on the replay's scans 1
and 0 at full width (P = Q = 1152) without early exit: the device time of
one extra round is (9 rounds - 1 round) / 8, by CUDA events over 200 calls,
so the launch and the targets' staging cancel. Parts:

  base        the round as it is
  no_update   the GN update (icp_update on one thread of every CTA)
  no_rowsum   the 13 sums of the rows (the 64-point trees, the blocks in order)
  no_barrier  the cluster barrier between the rows and their sums
  no_scan     the groups' scans of the targets (the shuffles stay)
  no_roundin  a point's moved position, dR/dtheta and rotated covariance
  no_sums     a point's 13 values (one of them is still written)

Prints the card's name and power limit, then one line a part, twice (in
turns).
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

EDITS = {
    "base": [],
    "no_update": [("const float norm = icp_update(acc, sdelta, blockIdx.x == 0 ? p.out : sout);",
                   "const float norm = acc[0] + 1.f;")],
    "no_rowsum": [("    rows_sum(rows, p.P, acc);",
                   "    for (int k = 0; k < kSums; ++k) acc[k] = rows[k];")],
    "no_barrier": [("    stage_sync();\n    float acc[kSums];", "    float acc[kSums];")],
    "no_scan": [("    if (live) scan_tile(mx, my, g, 0, p.Q, st, best);", "")],
    "no_roundin": [("if (live) in = round_in<kLoop>(p, i, d0, d1, d2);",
                    "if (live) in.mx = d0 + i;")],
    "no_sums": [("        for (int k = 0; k < kSums; ++k) rows[(long long)k * p.P + i] = v.v[k];",
                 "        rows[i] = v.v[0];"),
                ("        const Sums v = whole\n", "        const Sums v = false\n")],
}


def build(out: Path) -> dict:
    """{part: library path}, every copy built at once."""
    from graphslam_tpu_torch.ops import _build

    out.mkdir(parents=True, exist_ok=True)
    src = (_build.SRC_DIR / "icp_kernel.cu").read_text()
    for hdr in _build.sources("icp_kernel")[1:]:
        (out / hdr.name).write_text(hdr.read_text())
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not found once in icp_kernel.cu")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the copy {name}:\n{log[-3000:]}")
    return {name: out / f"{name}.so" for name in EDITS}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_round_parts: no CUDA device", file=sys.stderr)
        return 2
    from graphslam_tpu_torch.config import FrontendConfig
    from graphslam_tpu_torch.frontend import icp
    from graphslam_tpu_torch.frontend.projection import beam_angles, scan_to_points
    from graphslam_tpu_torch.ops import icp_kernel as ik
    from graphslam_tpu_torch.sim import simulate_trajectory

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build(ROOT / "graphslam_tpu_torch" / "build" / "parts")
    fc = FrontendConfig()
    sim = simulate_trajectory(fc, step_len=0.25, seed=1)
    dev = torch.device("cuda")
    angles = beam_angles(fc.num_beams, fc.fov_rad, device=dev)
    (sp, sm), (tp, tm) = (scan_to_points(torch.from_numpy(sim["scans"][t]).to(dev), angles,
                                         fc.min_range, fc.max_range, fc.max_points)
                          for t in (1, 0))
    init = torch.from_numpy(np.asarray(sim["odom_deltas"][0], np.float32)).to(dev)
    Cs, Ct = icp.surfel_covs(sp, sm, 4, 1e-3), icp.surfel_covs(tp, tm, 4, 1e-3)
    prob, keep = ik._problem(sp, None, ik._packed(Cs), sm, tp, tm, ik._packed(Ct), 1.0, 1e-6,
                             1e-5)
    delta = init.clone()
    prob.delta = delta.data_ptr()
    for _ in range(2):
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.icp_match.argtypes = [ctypes.POINTER(ik._Problem), ctypes.c_int, ctypes.c_int]
            us = {}
            for rounds in (1, 9):
                def call():
                    delta.copy_(init)
                    if lib.icp_match(ctypes.byref(prob), rounds, 0) != 0:
                        raise RuntimeError(f"{name}: icp_match failed")
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(200):
                    call()
                b.record()
                b.synchronize()
                us[rounds] = 1e3 * a.elapsed_time(b) / 200
            print(f"{name:11s} 1 round {us[1]:8.2f} us, 9 rounds {us[9]:8.2f} us, one round "
                  f"{(us[9] - us[1]) / 8:7.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
