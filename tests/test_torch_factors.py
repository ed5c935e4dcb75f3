"""The port's FactorGraph and SE(2) linearization against graphslam_tpu.factors.

Graphs are built once in JAX and carried over with from_numpy, so both
sides linearize the identical problem. Tolerance: rtol/atol 1e-5.

The elementwise Jacobian comparison runs in float64 on both sides. In
float32 the shared closed form of the Jacobian, (w cos w - sin w) / w^2 in
se2._V_terms, cancels catastrophically for 1e-4 < |w| < ~0.05: there the
last-ulp differences between JAX's and torch's sin/cos, amplified by the
x20 and x100 whitening, reach 3e-5 on single entries. float64 holds the
formulas themselves to 1e-5; chi2 is also checked in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.linearize import chi2 as jchi2
from graphslam_tpu.factors.linearize import linearize as jlinearize
from graphslam_tpu.factors.linearize import residuals as jresiduals
from graphslam_tpu.io import datasets
from graphslam_tpu_torch.factors import chi2, from_dataset, from_numpy
from graphslam_tpu_torch.factors.linearize import linearize, residuals

from _torch_port import FIELDS, carry

RTOL = ATOL = 1e-5


def _shuffled(data, seed=0):
    """Same graph with its edges in random order (as a real g2o file may
    list them), so the chain reorder has work to do."""
    perm = np.random.default_rng(seed).permutation(len(data["edges"]))
    out = dict(data)
    for k in ("edges", "measurements", "information", "is_loop"):
        out[k] = data[k][perm]
    return out


@pytest.mark.parametrize("shuffle", [False, True])
def test_from_dataset_same_perm_and_prefix(shuffle):
    data = datasets.manhattan(n_poses=200, loop_prob=0.4, seed=1)
    if shuffle:
        data = _shuffled(data)
    jg = jfrom_dataset(data)
    tg = from_dataset(data, device="cpu")
    assert tg.chain_prefix == jg.chain_prefix
    if not shuffle:
        assert tg.chain_prefix == 199
    for f in FIELDS:
        a, b = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_from_numpy_roundtrip_to_and_replace():
    data = datasets.manhattan(n_poses=80, seed=2)
    tg = carry(jfrom_dataset(data))
    back = from_numpy({f: getattr(tg, f).numpy() for f in FIELDS}, tg.chain_prefix,
                      device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(tg, f)), f
    assert back.chain_prefix == tg.chain_prefix
    moved = tg.to("cpu")
    assert moved.device == torch.device("cpu") and moved.chain_prefix == tg.chain_prefix
    mask = tg.edge_mask.clone()
    mask[0] = False
    rep = tg.replace(edge_mask=mask)
    assert not bool(rep.edge_mask[0]) and bool(tg.edge_mask[0])
    assert rep.num_edges == tg.num_edges and rep.tangent_dim == 3 and rep.pose_dim == 3


def _case(kind, dtype):
    data = datasets.manhattan(n_poses=120, loop_prob=0.5, seed=7)
    jg = jfrom_dataset(data, dtype=dtype)
    rng = np.random.default_rng(3)
    poses = data["poses"] + rng.normal(scale=[0.3, 0.3, 0.2], size=data["poses"].shape)
    poses = poses.astype(dtype)
    if kind == "masked":
        E, c = jg.num_edges, jg.chain_prefix
        mask = np.ones(E, bool)
        mask[[3, c - 2, c + 1, E - 1]] = False
        jg = jg.replace(edge_mask=jnp.asarray(mask),
                        prior_mask=jnp.zeros_like(jg.prior_mask))
    return jg, carry(jg), poses, dict(huber_delta=0.5, use_huber=(kind == "huber"))


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["plain", "huber", "masked"])
def test_linearize_and_chi2_match(kind):
    with jax.enable_x64(True):
        jg, tg, poses, kw = _case(kind, np.float64)
        lin = linearize(torch.from_numpy(poses), tg, **kw)
        jlin = jax.jit(jlinearize, static_argnames=("huber_delta", "use_huber"))(
            jnp.asarray(poses), jg, **kw)
        for name in ("r", "Ji", "Jj", "rp", "Jp"):
            _close(getattr(lin, name), getattr(jlin, name))
        _close(residuals(torch.from_numpy(poses), tg), jresiduals(jnp.asarray(poses), jg))
    jg32, tg32, poses32, _ = _case(kind, np.float32)
    for g_t, g_j, p in ((tg, jg, poses), (tg32, jg32, poses32)):
        with jax.enable_x64(p.dtype == np.float64):
            cj = float(jchi2(jnp.asarray(p), g_j, **kw))
        c = float(chi2(torch.from_numpy(p), g_t, **kw))
        assert abs(c - cj) <= RTOL * abs(cj), (p.dtype, c, cj)
    if kind == "masked":
        mask = tg.edge_mask.numpy()
        assert not lin.r.numpy()[~mask].any() and not lin.Ji.numpy()[~mask].any()


def test_se3_raises_named_roadmap_item():
    """SE(3) is ported (tests/test_torch_se3.py); a tangent dimension that
    names no pose group still raises, naming the two that exist."""
    from graphslam_tpu_torch.factors.linearize import group_for
    from graphslam_tpu_torch.geometry import se2, se3

    assert group_for(3) is se2 and group_for(6) is se3
    with pytest.raises(ValueError, match="SE\\(2\\): 3, SE\\(3\\): 6"):
        group_for(4)
