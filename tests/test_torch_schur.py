"""The port's partitioned Schur solvers (solver/schur.py,
parallel/dist_schur.py) against the JAX package's, on the CPU.

The same seeded graphs go to both packages (tests/_torch_port.py::carry);
the linear solves take the port's BlockSystem, carried into a JAX
BlockSystem, so both solve the same system. Every JAX function runs
jitted on the XLA CPU backend (the JAX package's own Schur tests run them
eagerly), once a signature.

Tolerances:
  * plans: every array equal, dtypes too;
  * schur_solve, dist_schur_solve: rtol 1e-3, atol 1e-4 against JAX's (the
    JAX mesh test's, tests/test_schur.py:58); the port's own dense solve
    at JAX's Schur-vs-dense tolerance (rtol 1e-2, atol 1e-3; SE(3) 2e-2,
    2e-3, tests/test_schur.py:26, :42); dist_schur_solve on one rank
    bitwise schur_solve;
  * dist_schur_gn_solve, 5 iterations: wrapped 1e-4 against JAX's at one
    device (measured 3.1e-6), and two gloo ranks against one rank at atol
    1e-4 (tests/test_schur.py:101);
  * a block that is not positive definite: dx NaN wherever JAX's is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.io import datasets
from graphslam_tpu.parallel import make_mesh as jmake_mesh
from graphslam_tpu.parallel import dist_schur as jdist_schur
from graphslam_tpu.solver import BlockSystem as JBlockSystem
from graphslam_tpu.solver import schur as jschur

from _torch_port import carry, run_ranks, wrapped_max
from graphslam_tpu_torch.factors import chi2, linearize
from graphslam_tpu_torch.parallel import make_mesh
from graphslam_tpu_torch.parallel.dist_schur import (
    dist_schur_gn_solve,
    dist_schur_solve,
    shard_schur_edges,
)
from graphslam_tpu_torch.solver import build_blocks, dense_solve
from graphslam_tpu_torch.solver.schur import schur_plan, schur_solve

GN_TOL = 1e-4
PROBLEMS = {
    "manhattan": lambda: datasets.manhattan(n_poses=120, seed=23),
    "sphere": lambda: datasets.sphere(n_rings=6, poses_per_ring=8, radius=4.0, seed=24),
    "manhattan160": lambda: datasets.manhattan(n_poses=160, seed=26),
    "manhattan160_loops": lambda: datasets.manhattan(n_poses=160, seed=26, loop_prob=0.25),
}
# (problem, blocks, lam): tests/test_schur.py's cases
CASES = [("manhattan", 2, 1e-4), ("manhattan", 4, 1e-4), ("manhattan", 7, 1e-4),
         ("sphere", 3, 1e-3)]


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, make in PROBLEMS.items():
        data = make()
        jg = jfrom_dataset(data)
        g = carry(jg)
        p0 = torch.from_numpy(np.asarray(data["poses"]))
        out[name] = (data, jg, g, p0, build_blocks(linearize(p0, g), g, p0.shape[0]))
    return out


def _jax_sys(sys):
    return JBlockSystem(*(jnp.asarray(x.numpy()) for x in sys))


def _jax_schur(jplan, sys, lam):
    return np.asarray(jax.jit(lambda s, l: jschur.schur_solve(jplan, s, l))(
        _jax_sys(sys), jnp.asarray(lam, jnp.float32)))


@pytest.mark.parametrize("name,blocks", [(c[0], c[1]) for c in CASES],
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_plan_matches_jax(problems, name, blocks):
    data, jg, g, p0, _ = problems[name]
    n = p0.shape[0]
    jp = jschur.schur_plan(np.asarray(jg.edges), n, blocks)
    p = schur_plan(g.edges.numpy(), n, blocks)
    assert p.Q > 0
    for f in jp._fields:
        a, b = getattr(jp, f), getattr(p, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("name,blocks,lam", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_schur_solve_matches_jax(problems, name, blocks, lam):
    data, jg, g, p0, sys = problems[name]
    n = p0.shape[0]
    p = schur_plan(g.edges.numpy(), n, blocks)
    dx = schur_solve(p, sys, torch.tensor(lam)).numpy()
    ref = _jax_schur(jschur.schur_plan(np.asarray(jg.edges), n, blocks), sys, lam)
    np.testing.assert_allclose(dx, ref, rtol=1e-3, atol=1e-4)
    rtol, atol = (2e-2, 2e-3) if name == "sphere" else (1e-2, 1e-3)
    np.testing.assert_allclose(dx, dense_solve(sys, torch.tensor(lam)).numpy(), rtol=rtol,
                               atol=atol)


def test_dist_schur_solve_one_rank(problems):
    # tests/test_schur.py::test_dist_schur_matches_single_device's graph
    data, jg, g, p0, sys = problems["manhattan160"]
    p = schur_plan(g.edges.numpy(), 160, 6)
    lam = torch.tensor(1e-4)
    out = dist_schur_solve(p, sys, lam, make_mesh(device="cpu"))
    assert torch.equal(out, schur_solve(p, sys, lam))
    ref = np.asarray(jdist_schur.dist_schur_solve(
        jschur.schur_plan(np.asarray(jg.edges), 160, 6), _jax_sys(sys), jnp.asarray(1e-4),
        jmake_mesh(num_devices=1)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-4)


def test_shard_schur_edges_matches_jax(problems):
    data, jg, g, p0, _ = problems["manhattan160_loops"]
    p = schur_plan(g.edges.numpy(), 160, 8)
    jplan_p, jshard = jdist_schur.shard_schur_edges(
        jg, jschur.schur_plan(np.asarray(jg.edges), 160, 8), 3)
    plan_p, shard = shard_schur_edges(g, p, 3)
    assert plan_p.B == jplan_p.B == 9
    assert np.array_equal(plan_p.interior_ids, jplan_p.interior_ids)
    assert sorted(shard) == sorted(jshard)
    for k, v in shard.items():
        assert np.array_equal(v.numpy(), np.asarray(jshard[k])), k


def test_dist_schur_gn_matches_jax(problems):
    # tests/test_schur.py::test_dist_schur_gn_sharded_mesh_invariant's graph
    data, jg, g, p0, _ = problems["manhattan160_loops"]
    p = schur_plan(g.edges.numpy(), 160, 8)
    out = dist_schur_gn_solve(p0, g, p, make_mesh(device="cpu"), iterations=5)
    ref = np.asarray(jdist_schur.dist_schur_gn_solve(
        jnp.asarray(data["poses"]), jg, jschur.schur_plan(np.asarray(jg.edges), 160, 8),
        jmake_mesh(num_devices=1), iterations=5))
    assert wrapped_max(out.numpy(), ref) <= GN_TOL
    assert float(chi2(out, g)) < 0.1 * float(chi2(p0, g))


def test_two_ranks_match_one_rank(problems, tmp_path):
    # 8 blocks on 2 ranks (4 each), the separator edges round-robin
    data, jg, g, p0, sys = problems["manhattan160_loops"]
    p = schur_plan(g.edges.numpy(), 160, 8)
    mesh = make_mesh(device="cpu")
    res = run_ranks(2, "schur", tmp_path)
    one = dist_schur_solve(p, sys, torch.tensor(1e-4), mesh).numpy()
    np.testing.assert_allclose(res["solve"], one, rtol=0, atol=GN_TOL)
    one_gn = dist_schur_gn_solve(p0, g, p, mesh, iterations=5).numpy()
    assert wrapped_max(res["gn"], one_gn) <= GN_TOL


@pytest.mark.parametrize("where", ["interior", "separator"])
def test_indefinite_block_gives_nan_as_jax(problems, where):
    data, jg, g, p0, sys = problems["manhattan"]
    p = schur_plan(g.edges.numpy(), 120, 4)
    k = int(p.interior_ids[1, 0]) if where == "interior" else int(p.sep_ids[0])
    diag = sys.diag.clone()
    diag[k] = -diag[k]
    bad = sys._replace(diag=diag)
    dx = schur_solve(p, bad, torch.tensor(1e-4)).numpy()
    ref = _jax_schur(jschur.schur_plan(np.asarray(jg.edges), 120, 4), bad, 1e-4)
    assert np.isnan(ref).any()
    assert np.array_equal(np.isnan(dx), np.isnan(ref))


@pytest.mark.parametrize("module,names", [
    ("solver", ("schur_plan", "schur_solve", "marginal_covariances_dense",
                "marginal_covariance_cg")),
    ("slam", ("OdometryBuffer", "integrate_twist")),
    ("sim", ("GridWorld", "load_pgm", "rasterize_world", "raycast_grid")),
], ids=["solver", "slam", "sim"])
def test_slice_exports_as_jax(module, names):
    # the names this slice ports are exported where the JAX package exports
    # them, and dist_schur's stay in their module in both packages
    import importlib

    for pkg in ("graphslam_tpu", "graphslam_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.{module}")
        for n in names:
            assert hasattr(mod, n), (pkg, module, n)
        par = importlib.import_module(f"{pkg}.parallel")
        assert not hasattr(par, "dist_schur_gn_solve"), pkg
