"""CLI: optimize a pose graph (g2o file or named synthetic benchmark) with the
PyTorch/CUDA port (graphslam_tpu_torch); the counterpart of scripts/solve.py,
with the same flags and printed lines, and --device.

  python scripts/solve_torch.py m3500 --plot /tmp/m3500.png
  python scripts/solve_torch.py path/to/intel.g2o --out /tmp/optimized.g2o
  python scripts/solve_torch.py m3500 --mode gn_fused --iters 50 --cg-iters 25 --huber
  python scripts/solve_torch.py city10000 --mode pcg --iters 100 --huber --device cpu

--mode takes every mode of SolverConfig: gn_fused runs the whole LM solve
in the fused kernel's LM mode (K1 on SE(2), K4 on SE(3)), pcg_fused runs
the LM loop with the fused PCG kernel (K3, K5) on a card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np
import torch

MODES = ["auto", "dense", "pcg", "pcg_fused", "gn_fused"]


def solver_config(args):
    from graphslam_tpu_torch.config import SolverConfig

    return SolverConfig(
        mode=args.mode,
        max_iterations=args.iters,
        cg_max_iterations=args.cg_iters,
        use_huber_on_loops=args.huber,
        preconditioner=args.precond,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", help="g2o path or benchmark name (m3500, intel, ...)")
    ap.add_argument("--mode", default="auto", choices=MODES)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--huber", action="store_true")
    ap.add_argument("--precond", default="tridiag", choices=["tridiag", "jacobi"])
    ap.add_argument(
        "--init", default="dataset", choices=["dataset", "chordal"],
        help="initial guess: dataset poses or SE(2) chordal bootstrap",
    )
    ap.add_argument("--out", help="write optimized graph to this g2o path")
    ap.add_argument("--plot", help="write trajectory plot to this png path")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from graphslam_tpu_torch import metrics, viz
    from graphslam_tpu_torch.factors import chi2, from_dataset
    from graphslam_tpu_torch.io import datasets, save_g2o
    from graphslam_tpu_torch.solver import lm_solve
    from graphslam_tpu_torch.utils import sync

    data = datasets.load(args.dataset)
    graph = from_dataset(data, device=args.device)
    poses0 = torch.as_tensor(data["poses"], device=args.device)
    if args.init == "chordal":
        if data["dim"] != 2:
            print("chordal init is SE(2)-only for now", file=sys.stderr)
            sys.exit(2)
        from graphslam_tpu_torch.solver.init import chordal_init_se2

        poses0 = chordal_init_se2(graph, poses0.shape[0])
    cfg = solver_config(args)

    t0 = time.time()
    out = lm_solve(poses0, graph, cfg)
    sync(out.poses)
    dt = time.time() - t0

    print(f"poses: {poses0.shape[0]}  edges: {graph.num_edges}", file=sys.stderr)
    print(
        f"chi2: {float(chi2(poses0, graph)):.1f} -> {float(out.error):.1f} "
        f"in {int(out.iterations)} LM iterations ({dt:.2f}s incl. compile)",
        file=sys.stderr,
    )
    if "gt" in data:
        gt = torch.as_tensor(data["gt"], device=args.device)
        print(
            f"ATE: {float(metrics.ate(poses0, gt)):.4f} -> "
            f"{float(metrics.ate(out.poses, gt)):.4f}",
            file=sys.stderr,
        )

    if args.out:
        U = graph.sqrt_info
        save_g2o(
            args.out,
            {
                "dim": data["dim"],
                "poses": out.poses.cpu().numpy(),
                "edges": graph.edges.cpu().numpy(),
                "measurements": graph.measurements.cpu().numpy(),
                "information": torch.einsum("eba,ebc->eac", U, U).cpu().numpy(),
            },
        )
        print(f"wrote {args.out}", file=sys.stderr)
    if args.plot:
        viz.plot_trajectory(
            out.poses,
            gt=data.get("gt"),
            edges=graph.edges,
            is_loop=graph.is_loop,
            path=args.plot,
            title=args.dataset,
        )
        print(f"wrote {args.plot}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
