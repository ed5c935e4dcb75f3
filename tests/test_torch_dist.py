"""The port's parallel/dist.py and parallel/multihost.py against the JAX package.

Same numpy inputs through graphslam_tpu.parallel.dist (the conftest's
virtual 8-device CPU mesh, cut to the same mesh size) and through the port
on gloo: one rank in this process, four ranks as four processes
(tests/_torch_dist_worker.py). The solves use a CG that converges (pcg, cg
300, tol 1e-10): at cg 50 the JAX package's own 1- and 4-device runs end
1e-2 apart on manhattan(300), roundoff amplified by the unconverged solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import SolverConfig as JaxSolverConfig
from graphslam_tpu.factors import from_dataset as jax_from_dataset
from graphslam_tpu.io import datasets as jax_datasets
from graphslam_tpu.parallel import dist as jdist
from graphslam_tpu.solver import gn_solve as jax_gn_solve

from _torch_dist_worker import DIST_CFG, DIST_ITERS
from _torch_port import carry, run_ranks, se3_max, wrapped_max
from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.parallel import (
    Mesh,
    dist_gn_solve,
    dist_lm_solve,
    make_mesh,
    multihost,
    shard_graph,
)

TOL_GN = 2e-3
TOL_LM = 3e-3
JAX_CFG = JaxSolverConfig(mode="pcg", cg_max_iterations=300, cg_tol=1e-10)


def _jax_problem(**kw):
    data = jax_datasets.manhattan(**kw)
    return data, jax_from_dataset(data)


def _jax_dist(data, jg, n_dev, lm, cfg=JAX_CFG, iterations=DIST_ITERS):
    mesh = jdist.make_mesh(num_devices=n_dev)
    solve = jdist.dist_lm_solve if lm else jdist.dist_gn_solve
    return np.asarray(solve(jnp.asarray(data["poses"]), jdist.shard_graph(jg, mesh), mesh,
                            cfg, iterations=iterations))


@pytest.fixture(scope="module")
def manhattan300():
    data, jg = _jax_problem(n_poses=300, seed=4, loop_prob=0.3)
    return data, jg, carry(jg), torch.from_numpy(np.asarray(data["poses"]))


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_mesh(device="cpu")


@pytest.mark.parametrize("lm", [False, True], ids=["gn", "lm"])
def test_one_rank_matches_jax(manhattan300, cpu_mesh, lm):
    data, jg, g, p0 = manhattan300
    solve = dist_lm_solve if lm else dist_gn_solve
    out = solve(p0, shard_graph(g, cpu_mesh), cpu_mesh, DIST_CFG, iterations=DIST_ITERS)
    ref = _jax_dist(data, jg, 1, lm)
    assert wrapped_max(out.numpy(), ref) <= (TOL_LM if lm else TOL_GN)


def test_four_ranks_match_jax_four_devices(manhattan300, tmp_path):
    data, jg, _, _ = manhattan300
    res = run_ranks(4, "dist", tmp_path)
    assert wrapped_max(res["gn"], _jax_dist(data, jg, 4, False)) <= TOL_GN
    assert wrapped_max(res["lm"], _jax_dist(data, jg, 4, True)) <= TOL_LM
    # test_distributed.py::test_edge_padding_is_harmless's twin: manhattan(8)
    # has 7 edges, padded to 8 over 4 ranks; masked pads change nothing
    d8, jg8 = _jax_problem(n_poses=8, seed=14, loop_prob=0.0)
    assert jg8.edges.shape[0] % 4 != 0
    single = np.asarray(jax_gn_solve(jnp.asarray(d8["poses"]), jg8,
                                     JaxSolverConfig(mode="pcg"), iterations=3))
    assert wrapped_max(res["padded"], single) <= 1e-3


def test_shard_graph_pads_and_partitions(manhattan300):
    _, _, g, _ = manhattan300
    E = g.num_edges
    n = 7
    assert E % n
    shards = [shard_graph(g, Mesh(group=None, rank=r, size=n, device=torch.device("cpu")))
              for r in range(n)]
    per = -(-E // n)
    assert all(s.num_edges == per for s in shards)
    edges = torch.cat([s.edges for s in shards])
    mask = torch.cat([s.edge_mask for s in shards])
    assert torch.equal(edges[:E], g.edges) and torch.equal(mask[:E], g.edge_mask)
    assert not mask[E:].any() and edges.shape[0] == n * per > E
    assert all(torch.equal(s.prior_idx, g.prior_idx) for s in shards)


def test_bitwise_repeatable(manhattan300, cpu_mesh):
    _, _, g, p0 = manhattan300
    sh = shard_graph(g, cpu_mesh)
    cfg = SolverConfig(mode="pcg", cg_max_iterations=40)
    a = dist_gn_solve(p0, sh, cpu_mesh, cfg, iterations=4)
    b = dist_gn_solve(p0, sh, cpu_mesh, cfg, iterations=4)
    assert torch.equal(a, b)


def test_se3_sphere_lm_matches_jax(cpu_mesh):
    data = jax_datasets.sphere(n_rings=4, poses_per_ring=8, radius=4.0, seed=13)
    jg = jax_from_dataset(data)
    ref = _jax_dist(data, jg, 1, True, iterations=4)
    g = carry(jg)
    p0 = torch.from_numpy(np.asarray(data["poses"]))
    out = dist_lm_solve(p0, shard_graph(g, cpu_mesh), cpu_mesh, DIST_CFG, iterations=4)
    assert se3_max(out.numpy(), ref) <= TOL_LM


def test_mesh_and_multihost_one_process(cpu_mesh):
    assert cpu_mesh.shape == {"dev": 1} and cpu_mesh.rank == 0
    assert multihost.is_coordinator()
    assert multihost.global_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="num_devices"):
        make_mesh(num_devices=4, device="cpu")
    t = torch.ones(3)
    assert cpu_mesh.all_reduce(t) is t and torch.equal(t, torch.ones(3))
