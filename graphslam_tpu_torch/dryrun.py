"""The port's dry-run entry points: a one-device GN step, and one run of
every distributed solver over a process group; the counterparts of the JAX
package's __graft_entry__.py (which stays the JAX package's dry run).

  python -c "from graphslam_tpu_torch import dryrun; dryrun.dryrun_multichip(1)"

A rank is a process here: `dryrun_multichip(n)` starts n processes of this
module, NCCL with one card a rank on "cuda" (it raises when there are fewer
cards than ranks) and gloo on "cpu", and returns rank 0's report.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 900.0


def entry(device="cuda"):
    """(fn, example_args): one Gauss-Newton step (linearize -> normal
    equations -> PCG solve -> retract) on an M3500-class SE(2) pose graph,
    manhattan(512), on `device`: the flagship compute path (the reference's
    solve(), graph.cpp:115-132)."""
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.factors import from_dataset, linearize
    from graphslam_tpu_torch.factors.linearize import group_for
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.solver import build_blocks, pcg_solve

    data = datasets.manhattan(n_poses=512, seed=0)
    graph = from_dataset(data, device=device)
    poses = torch.as_tensor(data["poses"], device=device)
    cfg = SolverConfig()

    def gn_step(poses, graph):
        lin = linearize(poses, graph)
        sys_ = build_blocks(lin, graph, poses.shape[0])
        dx = pcg_solve(
            sys_,
            torch.zeros((), dtype=poses.dtype, device=poses.device),
            max_iters=cfg.cg_max_iterations,
            tol=cfg.cg_tol,
        )
        return group_for(dx.shape[-1]).retract(poses, dx)

    return gn_step, (poses, graph)


def _run_rank(rank: int, world: int, port: int, device_type: str) -> dict:
    """This rank's part of the dry run: every distributed solver once, on
    tiny shapes, each output's shape asserted. Returns the shapes and the
    launch counts of the distributed kernels' wrappers (K6a-c, K7a-c)."""
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.parallel import (
        cg_step, cg_step6, dist_fused6_gn_solve, dist_fused_gn_solve, dist_fused_lm_solve,
        dist_lm_solve, multihost, shard_graph,
    )
    from graphslam_tpu_torch.parallel.dist_schur import dist_schur_gn_solve
    from graphslam_tpu_torch.solver.schur import schur_plan

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=dev)
    mesh = multihost.global_mesh(device=dev)
    data = datasets.manhattan(n_poses=64, seed=0)
    graph = from_dataset(data, device=dev)
    poses = torch.as_tensor(data["poses"], device=dev)
    cfg = SolverConfig(cg_max_iterations=25)
    shapes = {}

    def check(name, out, like):
        if out.shape != like.shape:
            raise RuntimeError(f"{name}: {tuple(out.shape)}, not {tuple(like.shape)}")
        shapes[name] = list(out.shape)

    # Factor-sharded LM (poses replicated, factors sharded, all-reduced
    # separators).
    check("dist_lm", dist_lm_solve(poses, shard_graph(graph, mesh), mesh, cfg, iterations=2),
          poses)
    # Pose-partitioned Schur reduction (one block a rank).
    plan = schur_plan(graph.edges.cpu().numpy(), poses.shape[0], world)
    check("dist_schur_gn", dist_schur_gn_solve(poses, graph, plan, mesh, iterations=1), poses)
    # The distributed fused-math solvers: sharded loop tiles, PCR-
    # preconditioned CG with one all-reduce a CG iteration; GN and LM.
    check("dist_fused_gn", dist_fused_gn_solve(poses, graph, mesh, cfg, iterations=2), poses)
    out4, _ = dist_fused_lm_solve(poses, graph, mesh, cfg, iterations=2)
    check("dist_fused_lm", out4, poses)
    # The CG-step kernels (K6a-c) at a short CG and 3 PCR levels.
    check("dist_fused_gn_cg_kernel", dist_fused_gn_solve(
        poses, graph, mesh, SolverConfig(cg_max_iterations=4, pcr_levels=3),
        iterations=1, cg_kernel=True), poses)
    # SE(3) distributed fused-math solver (K7a-c on the card).
    data6 = datasets.sphere(n_rings=4, poses_per_ring=8, radius=5.0, seed=1)
    graph6 = from_dataset(data6, device=dev)
    poses6 = torch.as_tensor(data6["poses"], device=dev)
    check("dist_fused6_gn", dist_fused6_gn_solve(
        poses6, graph6, mesh, SolverConfig(cg_max_iterations=8), iterations=1), poses6)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {f.__name__: f.launches for f in (
        cg_step.stage_a, cg_step.gn_setup, cg_step.cg_step,
        cg_step6.stage_a6, cg_step6.gn_setup6, cg_step6.cg_step6)}
    backend = str(torch.distributed.get_backend())
    torch.distributed.destroy_process_group()
    return {"world": world, "backend": backend, "shapes": shapes, "launches": launches}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run every distributed solver once over `n_devices` ranks, one process
    a rank (NCCL with one card a rank on "cuda", gloo on "cpu"), on tiny
    shapes, asserting each output's shape. Returns rank 0's report: the
    shapes and the kernel wrappers' launch counts. Raises when a rank fails
    or when `device` is "cuda" and there are fewer cards than ranks."""
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices > have:
            raise RuntimeError(f"dryrun_multichip({n_devices}) on cuda needs one card a rank; "
                               f"this host has {have}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if dev.type == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "graphslam_tpu_torch.dryrun", str(r), str(n_devices),
             str(port), dev.type, out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(n_devices)]
        try:
            results = [p.communicate(timeout=RANK_TIMEOUT_S) + (p.returncode,) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (_, err, rc) in enumerate(results):
            if rc != 0:
                raise RuntimeError(f"dry run rank {rank} of {n_devices} exited {rc}:\n"
                                   f"{err[-3000:]}")
        with open(out) as f:
            return json.load(f)


if __name__ == "__main__":
    rank_, world_, port_, device_type_, out_ = sys.argv[1:6]
    report = _run_rank(int(rank_), int(world_), int(port_), device_type_)
    if int(rank_) == 0:
        with open(out_, "w") as f:
            json.dump(report, f)
