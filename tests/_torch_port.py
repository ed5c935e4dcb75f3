"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py)."""

import math

import numpy as np

from graphslam_tpu_torch.factors import FactorGraph, from_numpy

FIELDS = ("edges", "measurements", "sqrt_info", "edge_mask", "is_loop",
          "prior_idx", "prior_meas", "prior_sqrt_info", "prior_mask")


def carry(jgraph) -> FactorGraph:
    """The port's FactorGraph holding a JAX FactorGraph's arrays."""
    return from_numpy({f: np.asarray(getattr(jgraph, f)) for f in FIELDS},
                      jgraph.chain_prefix, device="cpu")


def wrapped_max(a, b) -> float:
    """Max |a - b| over (N, 3) poses, the angle column taken modulo 2*pi."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[:, 2] = (d[:, 2] + math.pi) % (2 * math.pi) - math.pi
    return float(np.abs(d).max())


def se3_max(a, b) -> float:
    """Max |a - b| over (N, 12) SE(3) poses: the 9 row-major rotation
    entries and the 3 translation entries alike (no angle to wrap)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and a.shape[-1] == 12, (a.shape, b.shape)
    return float(np.abs(a - b).max())
