#!/usr/bin/env python3
"""End-to-end paths and K4's launch shape, one tree to a process, in turns
on one NVIDIA GPU: what chip_smoke.py cannot compare inside one process.

Usage, from the root of a checkout:

  python3 scripts/bench_persistent.py [--parent DIR] [--rounds R]

Trees:
  this         this checkout's graphslam_tpu_torch
  parent       with --parent, the package of another checkout (for example
               the parent commit unpacked with `git archive` into a
               directory that .gitignore lists)
  other-shape  a copy of this checkout's package (under
               graphslam_tpu_torch/build/, rebuilt there) whose
               csrc/se3_blocks.cuh::wide_shape takes the other launch
               shape: sphere2500 on one 16-CTA cluster walking 3 passes
               over the rows instead of a 42-CTA cooperative grid, garage
               on a 16-CTA cooperative grid instead of a 16-CTA cluster

Each tree runs in a fresh process (`--child DIR`), in the order parent,
this, other-shape, other-shape, this, parent, R times. A process builds
its tree's kernels (cached in the tree), warms up and prints one JSON
line:
  replay  frames/s of the 278-scan closed-loop replay (chip_smoke.py's
          phase 8 configuration), median of 3; and ms per call of K1's C
          entry (GnKernel.solve: one launch in this tree, the staged
          sequence in a tree from before the persistent K1) at the
          replay's last solve
          (the final map in its 128-pose bucket, 4 warm iterations at cg
          12, exact PCR), CUDA events over 50 calls
  dist    m3500 dist_fused GN it/s (200 iterations, cg 25, pcr_levels 4)
          and sphere2500 dist_fused6 GN it/s (20 iterations, cg 25), world
          size 1 over NCCL (phases 18 and 22)
  k4      ms per fused_gn6_solve at sphere2500 and garage (20 iterations,
          cg 25, exact PCR) and per fused_lm6_solve at garage (20 Huber
          steps), median of 3 chains of 5; the CTAs of the wide launch
The other-shape tree runs k4 only. The card's name and power limit come
first; the last line is a JSON summary of every process's numbers.
"""

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# The one line of wide_shape that picks the shape, and its other branch:
# the cluster where one pass over the rows takes more than 16 CTAs (capped
# at 16), the cooperative grid where it takes at most 16.
SHAPE_RULE = ("  if (want <= kMaxClusterCtas) {\n    sh = Shape{want, false};",
              "  if (want > kMaxClusterCtas) {\n    sh = Shape{kMaxClusterCtas, false};")


def _seconds(torch, fn, reps: int, chain: int) -> float:
    """Median seconds of `chain` back-to-back calls over `reps` reps."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def child_replay(torch):
    import numpy as np
    from graphslam_tpu_torch.config import SLAMConfig, SolverConfig
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.sim import simulate_trajectory
    from graphslam_tpu_torch.slam.pipeline import _solve_buckets, graph_view, make_slam_replay
    from graphslam_tpu_torch.slam.state import init_state

    cfg = SLAMConfig(max_keyframes=1024, max_factors=1024, solve_iterations=4,
                     solver=SolverConfig(mode="gn_fused", cg_max_iterations=12))
    sim = simulate_trajectory(cfg.frontend, step_len=0.25, seed=1)
    n = min(300, len(sim["scans"]))
    dev = torch.device("cuda")
    scans = torch.from_numpy(sim["scans"][:n]).to(dev)
    odom = torch.from_numpy(np.concatenate(
        [np.zeros((1, 3), np.float32), sim["odom_deltas"][: n - 1]])).to(dev)
    replay = make_slam_replay(cfg, n)
    out = {"replay_fps": n / _seconds(torch, lambda: replay(init_state(cfg), scans, odom), 3, 1)}

    # K1's C entry at the replay's own last solve: the final map in its
    # bucket, the warm iterations at the replay's cg, exact PCR
    state, _ = replay(init_state(cfg), scans, odom)
    B = next(b for b in _solve_buckets(cfg.max_keyframes, cfg.solve_bucket_min)
             if b >= int(state.num_kf))
    p0 = state.kf_poses[:B].clone()
    cg = cfg.solver.cg_max_iterations
    kern = gk.GnKernel(p0, graph_view(state, cfg, B), -1.0, cfg.solver.pcr_levels, cg_max=cg)
    phases = ((cfg.solve_iterations, cg),)

    def solve():
        kern.poses.copy_(p0)
        kern.solve(phases, True)
    solve()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(50):
        solve()
    b.record()
    b.synchronize()
    out["k1_replay_solve_ms"] = a.elapsed_time(b) / 50
    return out


def child_dist(torch):
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.parallel import dist_fused6_gn_solve, dist_fused_gn_solve, make_mesh

    dev = torch.device("cuda")
    mesh = make_mesh()
    out = {}
    for name, solve, iters, cfg in (
            ("dist_fused_m3500", dist_fused_gn_solve, 200,
             SolverConfig(cg_max_iterations=25, pcr_levels=4, edge_tile=512, hvp_splits=1)),
            ("dist_fused6_sphere2500", dist_fused6_gn_solve, 20,
             SolverConfig(cg_max_iterations=25, edge_tile=256, hvp_splits=1))):
        d = getattr(datasets, name.rsplit("_", 1)[1])()
        g, p0 = from_dataset(d, device=dev), torch.from_numpy(d["poses"]).to(dev)
        sec = _seconds(torch, lambda: solve(p0, g, mesh, cfg, iterations=iters), 3, 2) / 2
        out[f"{name}_it_s"] = iters / sec
    torch.distributed.destroy_process_group()
    return out


def child_k4(torch):
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import gn6_kernel as g6

    dev = torch.device("cuda")
    out = {}
    for name in ("sphere2500", "garage"):
        d = getattr(datasets, name)()
        g, p0 = from_dataset(d, device=dev), torch.from_numpy(d["poses"]).to(dev)
        runs = [(f"k4_{name}_gn_ms", lambda: g6.fused_gn6_solve(p0, g, 20, 25))]
        if name == "garage":
            runs.append((f"k4_{name}_lm_ms", lambda: g6.fused_lm6_solve(
                p0, g, 20, 25, huber_delta=1.0)))
        for key, fn in runs:
            out[key] = 1e3 * _seconds(torch, fn, 3, 5) / 5
        lib = g6.Gn6Kernel.load()
        if hasattr(lib, "gn6_wide_ctas"):  # a tree with the wide kernels
            out[f"k4_{name}_ctas"] = lib.gn6_wide_ctas(p0.shape[0])  # < 0: a grid
    return out


def child(tree: str, what: str) -> int:
    sys.path.insert(0, tree)
    import torch

    import graphslam_tpu_torch
    from graphslam_tpu_torch.ops import _build

    if Path(graphslam_tpu_torch.__file__).resolve().parent.parent != Path(tree).resolve():
        raise RuntimeError(f"imported {graphslam_tpu_torch.__file__}, not the tree {tree}")
    _build.build_all(["gn_kernel", "icp_kernel", "gn6_kernel", "cg_step", "cg_step6"])
    out = {}
    for part in what.split(","):
        out.update({"replay": child_replay, "dist": child_dist, "k4": child_k4}[part](torch))
    print(json.dumps(out), flush=True)
    return 0


def other_shape_tree() -> Path:
    """This checkout's package copied under its build directory, with
    wide_shape's rule swapped (SHAPE_RULE)."""
    dst = ROOT / "graphslam_tpu_torch" / "build" / "other-shape"
    pkg = dst / "graphslam_tpu_torch"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "graphslam_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    hdr = pkg / "csrc" / "se3_blocks.cuh"
    text = hdr.read_text()
    if text.count(SHAPE_RULE[0]) != 1:
        raise RuntimeError(f"wide_shape's rule not found once in {hdr}")
    hdr.write_text(text.replace(*SHAPE_RULE))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of another checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--what", default="replay,dist,k4", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.what)
    import torch

    if not torch.cuda.is_available():
        print("bench_persistent: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    trees = {"this": (ROOT, "replay,dist,k4"), "other-shape": (other_shape_tree(), "k4")}
    order = ["this", "other-shape"]
    if args.parent:
        trees["parent"] = (Path(args.parent).resolve(), "replay,dist,k4")
        order = ["parent"] + order
    results = {k: [] for k in trees}
    for _ in range(args.rounds):
        for label in order + order[::-1]:
            tree, what = trees[label]
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                                   str(tree), "--what", what], capture_output=True, text=True,
                                  cwd=str(tree))
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
                print(f"{label}: exit {proc.returncode}", file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            results[label].append(res)
            print(f"{label}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                           for k, v in res.items()), flush=True)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
