"""The port's parallel/dist_fused6.py against the JAX package's.

Same numpy inputs through graphslam_tpu.parallel.dist_fused6 and the port
at one rank: GN on sphere(8, 10, seed 27) and LM with Huber on sphere(6, 8,
seed 5), the graphs of tests/test_dist_fused6.py. The JAX side runs its XLA
loop (cg_kernel=False) at hvp_splits=3, where its bf16 hi/lo gathers are
within float32 roundoff of exact (the port never rounds to bf16). Those are
the file's only two JAX compiles (~50 s each): every other check holds the
port to itself, to its plain path or to its fused SE(3) kernel's twins
(fused_gn6_solve_reference, which tests/test_torch_gn6_kernel.py holds to
JAX). Tolerances, max |d| over the 12 pose entries: 2e-3 GN and 3e-3 LM
against JAX (under the ceilings of tests/test_dist_fused6.py, 5e-3 at :38
and 8e-3 at :51); 2e-4 between the kernel path's twins (cg_kernel=True on
the CPU) and the plain path, and between either and the K4 twin
(tests/test_dist_fused.py:170); 1e-5 of the largest coordinate across mesh
sizes, 2 and 4 ranks as gloo processes (tests/_torch_dist_worker.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import SolverConfig as JaxSolverConfig
from graphslam_tpu.factors import from_dataset as jax_from_dataset
from graphslam_tpu.io import datasets as jax_datasets
from graphslam_tpu.parallel import dist as jdist
from graphslam_tpu.parallel import dist_fused6 as jdf6

from _torch_dist_worker import FUSED6_CFG, FUSED6_LM_CFG, FUSED6_MASKED_CFG, sphere_problem
from _torch_port import carry, run_ranks, se3_max
from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import FactorGraph
from graphslam_tpu_torch.ops import gn6_kernel as g6
from graphslam_tpu_torch.parallel import (
    dist_fused6_gn_solve,
    dist_fused6_lm_solve,
    dist_fused_gn_solve,
    make_mesh,
)

TOL_GN = 2e-3
TOL_LM = 3e-3
TOL_KERNEL_PATH = 2e-4   # test_dist_fused.py:170
TOL_MESH = 1e-5          # of the largest coordinate
CFG = SolverConfig(cg_max_iterations=12, hvp_splits=3)
LM_CFG = SolverConfig(cg_max_iterations=10, hvp_splits=3, use_huber_on_loops=True,
                      huber_delta=1.0)


def _jax_cfg(cfg):
    return JaxSolverConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _problem(n_rings, poses_per_ring, seed):
    data = jax_datasets.sphere(n_rings=n_rings, poses_per_ring=poses_per_ring, radius=5.0,
                               seed=seed)
    jg = jax_from_dataset(data)
    return data, jg, carry(jg), torch.from_numpy(np.asarray(data["poses"]))


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_mesh(device="cpu")


@pytest.fixture(scope="module")
def sphere80():
    return _problem(8, 10, 27)


def test_plain_gn_matches_jax(sphere80, cpu_mesh):
    data, jg, g, p0 = sphere80
    out = dist_fused6_gn_solve(p0, g, cpu_mesh, CFG, iterations=3, cg_kernel=False)
    ref = jdf6.dist_fused6_gn_solve(jnp.asarray(data["poses"]), jg,
                                    jdist.make_mesh(num_devices=1), _jax_cfg(CFG), iterations=3,
                                    cg_kernel=False)
    assert out.shape == (80, 12)
    assert se3_max(out.numpy(), np.asarray(ref)) <= TOL_GN


def test_plain_lm_matches_jax(cpu_mesh):
    data, jg, g, p0 = _problem(6, 8, 5)
    out, (err, lam, n_acc) = dist_fused6_lm_solve(p0, g, cpu_mesh, LM_CFG, iterations=3,
                                                  cg_kernel=False)
    ref, (rerr, rlam, rn_acc) = jdf6.dist_fused6_lm_solve(
        jnp.asarray(data["poses"]), jg, jdist.make_mesh(num_devices=1), _jax_cfg(LM_CFG),
        iterations=3, cg_kernel=False)
    assert se3_max(out.numpy(), np.asarray(ref)) <= TOL_LM
    assert abs(float(err) - float(rerr)) <= 1e-4 * float(rerr)
    assert int(n_acc) == int(rn_acc)
    assert float(lam) == pytest.approx(float(rlam), rel=1e-6)
    assert err.shape == lam.shape == n_acc.shape == ()


@pytest.mark.parametrize("lm", [False, True], ids=["gn", "lm"])
def test_kernel_path_twins_match_plain_path(sphere80, cpu_mesh, lm):
    _, _, g, p0 = sphere80
    if lm:
        run = lambda k: dist_fused6_lm_solve(p0, g, cpu_mesh, LM_CFG, 3, cg_kernel=k)  # noqa: E731
        (a, sa), (b, sb) = run(True), run(False)
        assert int(sa[2]) == int(sb[2]) and float(sa[0]) == pytest.approx(float(sb[0]), rel=1e-5)
    else:
        a = dist_fused6_gn_solve(p0, g, cpu_mesh, CFG, 3, cg_kernel=True)
        b = dist_fused6_gn_solve(p0, g, cpu_mesh, CFG, 3, cg_kernel=False)
        # cg_kernel=None picks the plain path for CPU tensors
        assert torch.equal(dist_fused6_gn_solve(p0, g, cpu_mesh, CFG, 3), b)
    assert se3_max(a.numpy(), b.numpy()) <= TOL_KERNEL_PATH


def _chain_only(g):
    c = g.chain_prefix
    return g.replace(edges=g.edges[:c], measurements=g.measurements[:c],
                     sqrt_info=g.sqrt_info[:c], edge_mask=g.edge_mask[:c], is_loop=g.is_loop[:c])


@pytest.mark.parametrize("case", ["chain_only", "masked", "pcr_levels_3"])
def test_both_paths_match_the_k4_twin(sphere80, cpu_mesh, case):
    """No loop edges (every rank's loop partial empty), a third of the loop
    edges masked, and truncated PCR: both paths against the fused SE(3)
    kernel's twin on the same graph."""
    _, _, g, p0 = sphere80
    cfg = CFG
    if case == "chain_only":
        g = _chain_only(g)
        assert g.num_edges == g.chain_prefix
    elif case == "masked":
        g, _ = sphere_problem(mask_every=3)
    else:
        cfg = dataclasses.replace(CFG, pcr_levels=3)
    ref = g6.fused_gn6_solve_reference(p0, g, 3, cfg.cg_max_iterations,
                                       pcr_levels=cfg.pcr_levels)
    for kernel in (True, False):
        out = dist_fused6_gn_solve(p0, g, cpu_mesh, cfg, 3, cg_kernel=kernel)
        assert torch.isfinite(out).all()
        assert se3_max(out.numpy(), ref.numpy()) <= TOL_KERNEL_PATH, kernel


def test_gloo_ranks_match_one_rank(cpu_mesh, tmp_path):
    """Two and four gloo processes, every rank holding loop edges: the
    kernel path's twins and the plain path (whose chain each rank
    linearizes on its own node block) within 1e-5 of the largest coordinate
    of one rank (only the order of the ranks' partial sums differs), LM
    accepted steps equal."""
    g, p0 = sphere_problem()
    gm, _ = sphere_problem(mask_every=3)
    one = {
        "gn_kernel": dist_fused6_gn_solve(p0, g, cpu_mesh, FUSED6_CFG, 3, cg_kernel=True),
        "gn_plain": dist_fused6_gn_solve(p0, g, cpu_mesh, FUSED6_CFG, 3, cg_kernel=False),
        "masked_kernel": dist_fused6_gn_solve(p0, gm, cpu_mesh, FUSED6_MASKED_CFG, 3,
                                              cg_kernel=True),
    }
    lm_poses, lm_stats = dist_fused6_lm_solve(p0, g, cpu_mesh, FUSED6_LM_CFG, 3, cg_kernel=True)
    one["lm_kernel"] = lm_poses
    scale = float(p0[:, 9:].abs().max())
    for world in (2, 4):
        res = run_ranks(world, "fused6", tmp_path)
        for key, ref in one.items():
            assert se3_max(res[key], ref.numpy()) <= TOL_MESH * scale, (world, key)
        assert res["lm_stats"][2] == float(lm_stats[2])
        assert res["lm_stats"][0] == pytest.approx(float(lm_stats[0]), rel=1e-5)
    assert se3_max(res["gn_plain"], res["gn_kernel"]) <= TOL_KERNEL_PATH


def test_se2_input_rejected(cpu_mesh):
    data = jax_datasets.manhattan(n_poses=60, seed=1)
    g2 = carry(jax_from_dataset(data))
    with pytest.raises(ValueError, match="SE\\(3\\)"):
        dist_fused6_gn_solve(torch.from_numpy(np.asarray(data["poses"])), g2, cpu_mesh)
    g, _ = sphere_problem()
    with pytest.raises(ValueError, match="SE\\(3\\)"):
        dist_fused6_lm_solve(torch.zeros((80, 3)), g, cpu_mesh)
    with pytest.raises(ValueError, match="T=3"):
        dist_fused_gn_solve(torch.zeros((80, 12)), g, cpu_mesh)


@dataclasses.dataclass(frozen=True)
class _Bucketized(FactorGraph):
    """A graph that carries the JAX package's page-window field."""

    page_window: int = 2


def test_page_window_raises(cpu_mesh):
    g, p0 = sphere_problem()
    gb = _Bucketized(**{f.name: getattr(g, f.name) for f in dataclasses.fields(g)})
    with pytest.raises(ValueError, match="page_window"):
        dist_fused6_gn_solve(p0, gb, cpu_mesh, CFG)
