"""The port's parallel/dist_fused.py against the JAX package's.

Same numpy inputs through graphslam_tpu.parallel.dist_fused and the port,
at the same mesh size: one rank in this process, two and four ranks as gloo
processes (tests/_torch_dist_worker.py). The JAX side runs its XLA loop
(cg_kernel=False) at hvp_splits=3, where its bf16 hi/lo loop gathers are
within f32 roundoff of exact; at hvp_splits=1 they are not (3e-2 apart
after 4 GN iterations on manhattan(300)), and the port never rounds to bf16.
The kernel path's plain twins (cg_kernel=True on the CPU) are held to the
port's plain path, as test_dist_fused.py holds the JAX kernel path to its
XLA loop, and to themselves across mesh sizes.
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
from graphslam_tpu.parallel import dist_fused as jdf

from _torch_dist_worker import FUSED_CFG, FUSED_LM_CFG
from _torch_port import carry, run_ranks, wrapped_max
from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import FactorGraph
from graphslam_tpu_torch.parallel import dist_fused_gn_solve, dist_fused_lm_solve, make_mesh

TOL_GN = 2e-3
TOL_LM = 3e-3
TOL_KERNEL_PATH = 2e-4   # test_dist_fused.py:170
TOL_MESH = 1e-5          # test_dist_fused.py:55, :188
CFG = SolverConfig(cg_max_iterations=15, hvp_splits=3)
LM_CFG = dataclasses.replace(CFG, use_huber_on_loops=True, huber_delta=1.0)


def _jax_cfg(cfg):
    return JaxSolverConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _problem(n_poses=300, seed=4, loop_prob=0.3, mask_every=0):
    data = jax_datasets.manhattan(n_poses=n_poses, seed=seed, loop_prob=loop_prob)
    jg = jax_from_dataset(data)
    if mask_every:
        mask = np.array(jg.edge_mask)
        mask[jg.chain_prefix::mask_every] = False
        jg = jg.replace(edge_mask=jnp.asarray(mask))
    return data, jg, carry(jg), torch.from_numpy(np.asarray(data["poses"]))


def _jax_gn(data, jg, cfg, n_dev, iterations):
    return np.asarray(jdf.dist_fused_gn_solve(
        jnp.asarray(data["poses"]), jg, jdist.make_mesh(num_devices=n_dev), _jax_cfg(cfg),
        iterations=iterations, cg_kernel=False))


@pytest.fixture(scope="module")
def manhattan300():
    return _problem()


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_mesh(device="cpu")


def test_plain_gn_matches_jax(manhattan300, cpu_mesh):
    data, jg, g, p0 = manhattan300
    out = dist_fused_gn_solve(p0, g, cpu_mesh, CFG, iterations=4, cg_kernel=False)
    assert wrapped_max(out.numpy(), _jax_gn(data, jg, CFG, 1, 4)) <= TOL_GN


def test_plain_lm_matches_jax(manhattan300, cpu_mesh):
    data, jg, g, p0 = manhattan300
    out, (err, lam, n_acc) = dist_fused_lm_solve(p0, g, cpu_mesh, LM_CFG, iterations=5,
                                                 cg_kernel=False)
    ref, (rerr, rlam, rn_acc) = jdf.dist_fused_lm_solve(
        jnp.asarray(data["poses"]), jg, jdist.make_mesh(num_devices=1), _jax_cfg(LM_CFG),
        iterations=5, cg_kernel=False)
    assert wrapped_max(out.numpy(), np.asarray(ref)) <= TOL_LM
    assert abs(float(err) - float(rerr)) <= 1e-4 * float(rerr)
    assert int(n_acc) == int(rn_acc)
    assert float(lam) == pytest.approx(float(rlam), rel=1e-6)


@pytest.mark.parametrize("lm", [False, True], ids=["gn", "lm"])
def test_kernel_path_twins_match_plain_path(manhattan300, cpu_mesh, lm):
    _, _, g, p0 = manhattan300
    if lm:
        run = lambda k: dist_fused_lm_solve(p0, g, cpu_mesh, LM_CFG, 5, cg_kernel=k)  # noqa: E731
        (a, sa), (b, sb) = run(True), run(False)
        assert int(sa[2]) == int(sb[2])
    else:
        a = dist_fused_gn_solve(p0, g, cpu_mesh, CFG, 4, cg_kernel=True)
        b = dist_fused_gn_solve(p0, g, cpu_mesh, CFG, 4, cg_kernel=False)
    assert wrapped_max(a.numpy(), b.numpy()) <= TOL_KERNEL_PATH
    # cg_kernel=None picks the plain path for CPU tensors
    if not lm:
        assert torch.equal(dist_fused_gn_solve(p0, g, cpu_mesh, CFG, 4), b)


def test_chain_only_graph(cpu_mesh):
    """No loop edges: every rank's loop partial is empty."""
    _, _, g, p0 = _problem(n_poses=120, seed=2, loop_prob=0.0)
    assert g.num_edges == g.chain_prefix
    a = dist_fused_gn_solve(p0, g, cpu_mesh, FUSED_CFG, iterations=3, cg_kernel=True)
    b = dist_fused_gn_solve(p0, g, cpu_mesh, FUSED_CFG, iterations=3, cg_kernel=False)
    assert torch.isfinite(a).all() and wrapped_max(a.numpy(), b.numpy()) <= TOL_KERNEL_PATH


def test_truncated_pcr_and_masked_loops_match_jax(cpu_mesh):
    """test_dist_fused.py:77's twin: a third of the loop edges masked,
    truncated PCR; the kernel path's twins against the JAX XLA loop."""
    data, jg, g, p0 = _problem(n_poses=200, seed=7, loop_prob=0.25, mask_every=3)
    out = dist_fused_gn_solve(p0, g, cpu_mesh, FUSED_CFG, iterations=3, cg_kernel=True)
    assert wrapped_max(out.numpy(), _jax_gn(data, jg, FUSED_CFG, 1, 3)) <= TOL_GN


def test_gloo_ranks_match_one_rank_and_jax(manhattan300, cpu_mesh, tmp_path):
    """Two and four gloo processes: the kernel path's twins within 1e-5 of
    one rank (only the all-reduce's order of the loop partials differs),
    LM accepted steps equal; the plain path at four ranks, whose
    preconditioner runs per rank on node blocks (pcr_levels 3), against the
    JAX XLA loop at four devices, whose slab-PCR branch engages there."""
    data, jg, g, p0 = manhattan300
    _, _, gm, pm = _problem(n_poses=200, seed=7, loop_prob=0.25, mask_every=3)
    one = {
        "gn_kernel": dist_fused_gn_solve(p0, g, cpu_mesh, FUSED_CFG, 3, cg_kernel=True),
        "masked_kernel": dist_fused_gn_solve(pm, gm, cpu_mesh, FUSED_CFG, 3, cg_kernel=True),
    }
    lm_poses, lm_stats = dist_fused_lm_solve(p0, g, cpu_mesh, FUSED_LM_CFG, 3, cg_kernel=True)
    one["lm_kernel"] = lm_poses
    for world in (2, 4):
        res = run_ranks(world, "fused", tmp_path)
        for key, ref in one.items():
            assert wrapped_max(res[key], ref.numpy()) <= TOL_MESH, (world, key)
        assert res["lm_stats"][2] == float(lm_stats[2])
        assert res["lm_stats"][0] == pytest.approx(float(lm_stats[0]), rel=1e-5)
    assert wrapped_max(res["gn_plain"], _jax_gn(data, jg, FUSED_CFG, 4, 3)) <= TOL_GN
    assert wrapped_max(res["gn_plain"], res["gn_kernel"]) <= TOL_KERNEL_PATH


def test_se3_input_rejected(cpu_mesh):
    data = jax_datasets.sphere(n_rings=3, poses_per_ring=6, seed=1)
    g = carry(jax_from_dataset(data))
    with pytest.raises(ValueError, match="T=3"):
        dist_fused_gn_solve(torch.from_numpy(np.asarray(data["poses"])), g, cpu_mesh)
    _, _, g2, _ = _problem(n_poses=100, seed=1)
    with pytest.raises(ValueError, match="T=3"):
        dist_fused_gn_solve(torch.zeros((100, 12)), g2, cpu_mesh)


@dataclasses.dataclass(frozen=True)
class _Bucketized(FactorGraph):
    """A graph that carries the JAX package's page-window field."""

    page_window: int = 2


def test_page_window_raises(manhattan300, cpu_mesh):
    _, _, g, p0 = manhattan300
    gb = _Bucketized(**{f.name: getattr(g, f.name) for f in dataclasses.fields(g)})
    with pytest.raises(ValueError, match="page_window"):
        dist_fused_gn_solve(p0, gb, cpu_mesh, CFG)


def test_mesh_builds_on_the_card_by_default(cpu_mesh):
    """Without a device argument make_mesh takes the card: without one it
    raises instead of handing back a CPU mesh."""
    if torch.cuda.is_available():
        assert make_mesh().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make_mesh()
