"""The port's so2/se2 against graphslam_tpu.geometry on the same numpy inputs.

Tolerance: atol 1e-5 in float32 (both sides evaluate the same closed forms;
only the libm sin/cos/atan2 differ in the last ulps). Angles are compared
modulo 2*pi, since wrap() may land on +pi on one side and -pi on the other.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.geometry import se2 as jse2
from graphslam_tpu.geometry import so2 as jso2
from graphslam_tpu_torch.geometry import se2, so2

ATOL = 1e-5
# small |w| (both series switches, 1e-6 and 1e-4, from both sides), and
# angles near +-pi away from the exact branch point
SPECIAL_W = [0.0, 1e-7, -1e-7, 9e-7, 2e-6, -5e-5, 9e-5, 2e-4, -2e-4, 1e-3,
             math.pi - 1e-5, -math.pi + 1e-5, 3.1, -3.1]


def _poses(n=64, seed=0):
    rng = np.random.default_rng(seed)
    p = np.concatenate(
        [rng.normal(scale=3.0, size=(n, 2)), rng.uniform(-math.pi, math.pi, (n, 1))], 1
    )
    w = np.asarray(SPECIAL_W)
    p[: len(w), 2] = w
    return p.astype(np.float32)


def _tangents(n=64, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.normal(scale=0.5, size=(n, 3))
    v[: len(SPECIAL_W), 2] = SPECIAL_W
    return v.astype(np.float32)


def _cmp(ours, ref, angle_cols=()):
    a = ours.detach().numpy().astype(np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape
    d = a - b
    for c in angle_cols:
        d[..., c] = (d[..., c] + math.pi) % (2 * math.pi) - math.pi
    assert np.abs(d).max() <= ATOL, np.abs(d).max()


def test_wrap_and_rotations():
    th = np.concatenate([
        np.linspace(-20, 20, 101), [math.pi, -math.pi, 0.0, 1e-7]
    ]).astype(np.float32)
    t = torch.from_numpy(th)
    ours = so2.wrap(t)
    assert float(ours.abs().max()) <= math.pi + 1e-6
    _cmp(ours[:, None], np.asarray(jso2.wrap(jnp.asarray(th)))[:, None], angle_cols=(0,))
    v = _poses()[:, :2]
    _cmp(so2.rotate(torch.from_numpy(_poses()[:, 2]), torch.from_numpy(v)),
         jso2.rotate(jnp.asarray(_poses()[:, 2]), jnp.asarray(v)))
    _cmp(so2.unrotate(torch.from_numpy(_poses()[:, 2]), torch.from_numpy(v)),
         jso2.unrotate(jnp.asarray(_poses()[:, 2]), jnp.asarray(v)))


@pytest.mark.parametrize(
    "fn, args, angle_cols",
    [
        ("compose", ("p", "q"), (2,)),
        ("between", ("p", "q"), (2,)),
        ("inverse", ("p",), (2,)),
        ("exp", ("v",), (2,)),
        ("log", ("p",), ()),
        ("retract", ("p", "v"), (2,)),
        ("local", ("p", "q"), ()),
        ("adjoint", ("p",), ()),
        ("left_jacobian_inv", ("v",), ()),
        ("right_jacobian_inv", ("v",), ()),
    ],
)
def test_se2_matches_jax(fn, args, angle_cols):
    inputs = {"p": _poses(seed=0), "q": _poses(seed=2), "v": _tangents()}
    ours = getattr(se2, fn)(*(torch.from_numpy(inputs[a]) for a in args))
    ref = getattr(jse2, fn)(*(jnp.asarray(inputs[a]) for a in args))
    _cmp(ours, ref, angle_cols)


def test_log_exp_roundtrip():
    v = torch.from_numpy(_tangents())
    v = v[v[:, 2].abs() < 3.0]
    back = se2.log(se2.exp(v))
    assert torch.allclose(back, v, atol=1e-4)
