"""One rank of a multi-process run of the port's distributed solvers, on gloo.

Usage:  python tests/_torch_dist_worker.py RANK WORLD PORT OUT.npz SCENARIO

The RANK-th of WORLD processes joins a gloo group at tcp://127.0.0.1:PORT
through parallel/multihost.initialize, runs SCENARIO on CPU tensors and,
on rank 0, saves the results to OUT.npz. It imports no jax: the tests
(tests/test_torch_dist.py, tests/test_torch_dist_fused.py,
tests/test_torch_dist_fused6.py) hold the saved poses against the JAX
package and against one-rank runs.

  dist    parallel/dist.py: dist_gn_solve and dist_lm_solve on
          manhattan(300, seed 4, loop_prob 0.3) at the converging CG config
          (pcg, cg 300, tol 1e-10), 3 iterations each, and dist_gn_solve on
          manhattan(8) (fewer edges than a multiple of the ranks: padded)
  fused   parallel/dist_fused.py on manhattan(300, seed 4, loop_prob 0.3)
          and cg 12, pcr_levels 3: the kernel path's twins (GN 3
          iterations, LM + Huber 3 iterations) and the plain path (GN);
          and the kernel path's twins on manhattan(200, seed 7) with every
          third loop edge masked
  fused6  parallel/dist_fused6.py on sphere(8, 10, seed 27) in tiles of 6
          loop edges (every rank holds some) and cg 6: the kernel path's
          twins (GN 3 iterations, LM + Huber 3 steps) and the plain path
          (GN), and the kernel path's twins with every third loop edge
          masked at pcr_levels 3
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from graphslam_tpu_torch.config import SolverConfig  # noqa: E402
from graphslam_tpu_torch.factors import from_dataset  # noqa: E402
from graphslam_tpu_torch.io import datasets  # noqa: E402
from graphslam_tpu_torch.parallel import (  # noqa: E402
    dist_fused6_gn_solve,
    dist_fused6_lm_solve,
    dist_fused_gn_solve,
    dist_fused_lm_solve,
    dist_gn_solve,
    dist_lm_solve,
    multihost,
    shard_graph,
)

# the configs the tests hold these runs to (imported there too)
DIST_CFG = SolverConfig(mode="pcg", cg_max_iterations=300, cg_tol=1e-10)
DIST_ITERS = 3
FUSED_CFG = SolverConfig(cg_max_iterations=12, pcr_levels=3, hvp_splits=3)
FUSED_LM_CFG = SolverConfig(cg_max_iterations=12, pcr_levels=3, hvp_splits=3,
                            use_huber_on_loops=True, huber_delta=1.0)
FUSED6_CFG = SolverConfig(cg_max_iterations=6, edge_tile=6)
FUSED6_LM_CFG = SolverConfig(cg_max_iterations=6, edge_tile=6, use_huber_on_loops=True,
                             huber_delta=1.0)
FUSED6_MASKED_CFG = SolverConfig(cg_max_iterations=6, edge_tile=6, pcr_levels=3)


def problem(n_poses=300, seed=4, loop_prob=0.3, mask_every=0):
    """(graph, poses0) on the CPU, every `mask_every`-th loop edge masked."""
    data = datasets.manhattan(n_poses=n_poses, seed=seed, loop_prob=loop_prob)
    g = from_dataset(data, device="cpu")
    if mask_every:
        mask = g.edge_mask.clone()
        mask[g.chain_prefix::mask_every] = False
        g = g.replace(edge_mask=mask)
    return g, torch.from_numpy(data["poses"])


def run_dist(mesh):
    g, p0 = problem()
    sh = shard_graph(g, mesh)
    out = {"gn": dist_gn_solve(p0, sh, mesh, DIST_CFG, iterations=DIST_ITERS),
           "lm": dist_lm_solve(p0, sh, mesh, DIST_CFG, iterations=DIST_ITERS)}
    g8, p8 = problem(n_poses=8, seed=14, loop_prob=0.0)
    out["padded"] = dist_gn_solve(p8, shard_graph(g8, mesh), mesh,
                                  SolverConfig(mode="pcg"), iterations=3)
    return out


def run_fused(mesh):
    g, p0 = problem()
    out = {"gn_kernel": dist_fused_gn_solve(p0, g, mesh, FUSED_CFG, iterations=3,
                                            cg_kernel=True),
           "gn_plain": dist_fused_gn_solve(p0, g, mesh, FUSED_CFG, iterations=3,
                                           cg_kernel=False)}
    poses, (err, lam, n_acc) = dist_fused_lm_solve(p0, g, mesh, FUSED_LM_CFG, iterations=3,
                                                   cg_kernel=True)
    out.update(lm_kernel=poses, lm_stats=torch.stack([err, lam, n_acc]))
    gm, pm = problem(n_poses=200, seed=7, loop_prob=0.25, mask_every=3)
    out["masked_kernel"] = dist_fused_gn_solve(pm, gm, mesh, FUSED_CFG, iterations=3,
                                               cg_kernel=True)
    return out


def sphere_problem(mask_every=0):
    """sphere(8, 10, seed 27, radius 5) (tests/test_dist_fused6.py's graph)
    as (graph, poses0) on the CPU, every `mask_every`-th loop edge masked."""
    data = datasets.sphere(n_rings=8, poses_per_ring=10, radius=5.0, seed=27)
    g = from_dataset(data, device="cpu")
    if mask_every:
        mask = g.edge_mask.clone()
        mask[g.chain_prefix::mask_every] = False
        g = g.replace(edge_mask=mask)
    return g, torch.from_numpy(data["poses"])


def run_fused6(mesh):
    g, p0 = sphere_problem()
    out = {"gn_kernel": dist_fused6_gn_solve(p0, g, mesh, FUSED6_CFG, iterations=3,
                                             cg_kernel=True),
           "gn_plain": dist_fused6_gn_solve(p0, g, mesh, FUSED6_CFG, iterations=3,
                                            cg_kernel=False)}
    poses, (err, lam, n_acc) = dist_fused6_lm_solve(p0, g, mesh, FUSED6_LM_CFG, iterations=3,
                                                    cg_kernel=True)
    out.update(lm_kernel=poses, lm_stats=torch.stack([err, lam, n_acc]))
    gm, _ = sphere_problem(mask_every=3)
    out["masked_kernel"] = dist_fused6_gn_solve(p0, gm, mesh, FUSED6_MASKED_CFG, iterations=3,
                                                cg_kernel=True)
    return out


SCENARIOS = {"dist": run_dist, "fused": run_fused, "fused6": run_fused6}


def main() -> None:
    rank, world, port, out_path, scenario = sys.argv[1:6]
    multihost.initialize(f"127.0.0.1:{port}", int(world), int(rank), device="cpu")
    mesh = multihost.global_mesh(device="cpu")
    out = SCENARIOS[scenario](mesh)
    if multihost.is_coordinator():
        np.savez(out_path, **{k: v.numpy() for k, v in out.items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
