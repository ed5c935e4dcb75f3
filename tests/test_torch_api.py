"""Public names of the JAX package that the port serves the same way.

Each check imports the name from graphslam_tpu and from graphslam_tpu_torch:
the lazy top-level conveniences and the `geometry` import, the SE(3)
chordal init in solver/, geometry.se2.identity, the x0 warm start of
solver.normal_eq.pcg_solve (held to the JAX function with x0 given, rel
1e-4 of the warm start's largest entry, float32 sums in another order) and
utils.profiler_trace.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphslam_tpu
import graphslam_tpu_torch
from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.linearize import linearize as jlinearize
from graphslam_tpu.io import datasets
from graphslam_tpu.solver import normal_eq as jne

from _torch_port import carry

LAZY = {
    "from_dataset": "factors",
    "lm_solve": "solver",
    "gn_solve": "solver",
    "run_slam": "slam",
    "load": "io.datasets",
    "ate": "metrics",
}


@pytest.mark.parametrize("name", sorted(LAZY))
def test_lazy_top_level_names(name):
    ours = getattr(graphslam_tpu_torch, name)
    ref = getattr(graphslam_tpu, name)
    assert callable(ours) and callable(ref)
    assert ours is getattr(importlib.import_module(f"graphslam_tpu_torch.{LAZY[name]}"), name)
    assert ref is getattr(importlib.import_module(f"graphslam_tpu.{LAZY[name]}"), name)
    assert ours.__module__.startswith("graphslam_tpu_torch.")


def test_geometry_imported_and_unknown_name_raises():
    for pkg in (graphslam_tpu, graphslam_tpu_torch):
        assert pkg.geometry.se2.compose and pkg.geometry.se3.compose
        with pytest.raises(AttributeError, match="no attribute"):
            getattr(pkg, "no_such_name")


def test_chordal_init_se3_exported():
    from graphslam_tpu.solver import chordal_init_se3 as ref
    from graphslam_tpu_torch.solver import chordal_init_se3
    from graphslam_tpu_torch.solver.init import chordal_init_se3 as defined

    assert chordal_init_se3 is defined and callable(ref)


def test_se2_identity():
    from graphslam_tpu.geometry import se2 as jse2
    from graphslam_tpu_torch.geometry import se2

    ours = se2.identity((2, 4), device="cpu")
    ref = np.asarray(jse2.identity((2, 4)))
    assert ours.shape == ref.shape and ours.dtype == torch.float32 and ours.device.type == "cpu"
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert se2.identity().shape == (3,)
    assert se2.identity(dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("preconditioner", ["tridiag", "jacobi"])
def test_pcg_solve_warm_start_matches_jax(preconditioner):
    from graphslam_tpu_torch.factors.linearize import linearize
    from graphslam_tpu_torch.solver import normal_eq as ne

    data = datasets.manhattan(n_poses=120, loop_prob=0.25, seed=0)
    jg = jfrom_dataset(data)
    tg = carry(jg)
    p0 = data["poses"]
    n = p0.shape[0]
    jsys = jax.jit(lambda p: jne.build_blocks(jlinearize(p, jg), jg, n))(jnp.asarray(p0))
    tsys = ne.build_blocks(linearize(torch.from_numpy(p0), tg), tg, n)
    x0 = np.random.default_rng(1).normal(scale=0.1, size=(n, 3)).astype(np.float32)
    kw = dict(max_iters=3, tol=1e-8, preconditioner=preconditioner,
              chain_prefix=jg.chain_prefix)
    ref = np.asarray(jne.pcg_solve(jsys, jnp.float32(1e-3), x0=jnp.asarray(x0), **kw))
    ours = ne.pcg_solve(tsys, 1e-3, x0=torch.from_numpy(x0), **kw).numpy()
    # the iterates descend from x0 toward a solution far smaller than x0:
    # the roundoff of the descent scales with x0
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(x0).max()
    # no iteration: both return the warm start itself
    kw["max_iters"] = 0
    np.testing.assert_array_equal(ne.pcg_solve(tsys, 1e-3, x0=torch.from_numpy(x0), **kw), x0)
    np.testing.assert_array_equal(jne.pcg_solve(jsys, jnp.float32(1e-3), x0=jnp.asarray(x0),
                                                **kw), x0)


def test_profiler_trace_writes_a_trace(tmp_path):
    from graphslam_tpu.utils import profiler_trace as ref
    from graphslam_tpu_torch.utils import profiler_trace

    assert callable(ref)
    with profiler_trace(tmp_path):
        torch.ones(8).cumsum(0)
    traces = list(tmp_path.rglob("*.json"))
    assert traces and traces[0].stat().st_size > 0
