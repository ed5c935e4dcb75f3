"""FactorGraph: the pose-graph problem as a dataclass of flat tensors.

Port of graphslam_tpu/factors/graph.py. Layout (struct-of-arrays):
  edges        (E, 2) int32   between-factor endpoints (i, j)
  measurements (E, D)         relative pose z_ij (D=3 for SE2)
  sqrt_info    (E, T, T)      upper Cholesky factor of the information matrix
  edge_mask    (E,)  bool     validity (online graphs grow by flipping bits)
  is_loop      (E,)  bool     loop-closure edges (robust-kernel scope)
  prior_idx    (P,)  int32    anchored nodes
  prior_meas   (P, D)         anchor poses
  prior_sqrt_info (P, T, T)
  prior_mask   (P,)  bool

`chain_prefix` says that the first chain_prefix edges are exactly (k, k+1),
the odometry chain. The JAX package's page-window fields (tile_page0,
page_window) exist for the TPU's one-hot gathers and are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

_TENSOR_FIELDS = (
    "edges", "measurements", "sqrt_info", "edge_mask", "is_loop",
    "prior_idx", "prior_meas", "prior_sqrt_info", "prior_mask",
)


@dataclasses.dataclass(frozen=True)
class FactorGraph:
    edges: torch.Tensor
    measurements: torch.Tensor
    sqrt_info: torch.Tensor
    edge_mask: torch.Tensor
    is_loop: torch.Tensor
    prior_idx: torch.Tensor
    prior_meas: torch.Tensor
    prior_sqrt_info: torch.Tensor
    prior_mask: torch.Tensor
    chain_prefix: int = 0

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def tangent_dim(self) -> int:
        return self.sqrt_info.shape[-1]

    @property
    def pose_dim(self) -> int:
        return self.measurements.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.edges.device

    def replace(self, **kw) -> "FactorGraph":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "FactorGraph":
        return self.replace(**{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})


def _chol_info(info: np.ndarray) -> np.ndarray:
    """Upper sqrt-information: info = U^T U with U upper triangular, so the
    whitened residual is U @ r."""
    L = np.linalg.cholesky(info)  # info = L L^T
    return np.swapaxes(L, -1, -2)


def _chain_reorder(edges: np.ndarray, n_poses: int):
    """Permutation putting one (k, k+1) edge at position k for the longest
    possible k-run (the odometry chain), remaining edges after. Returns
    (perm, chain_prefix)."""
    E = edges.shape[0]
    slot = {}
    for e in range(E):
        i, j = int(edges[e, 0]), int(edges[e, 1])
        if j == i + 1 and i not in slot:
            slot[i] = e
    prefix = []
    for k in range(n_poses - 1):
        if k in slot:
            prefix.append(slot[k])
        else:
            break
    chain = set(prefix)
    rest = [e for e in range(E) if e not in chain]
    return np.asarray(prefix + rest, np.int64), len(prefix)


def from_numpy(
    fields: Dict[str, np.ndarray], chain_prefix: int, device="cuda"
) -> FactorGraph:
    """Build a FactorGraph on `device` from numpy arrays named as the
    dataclass fields (for example a JAX FactorGraph's arrays fetched with
    np.asarray). Integer fields become int32, masks bool, the rest keep
    their float dtype."""
    out = {}
    for f in _TENSOR_FIELDS:
        a = np.asarray(fields[f])
        if f in ("edges", "prior_idx"):
            a = a.astype(np.int32)
        elif f in ("edge_mask", "is_loop", "prior_mask"):
            a = a.astype(bool)
        out[f] = torch.tensor(a, device=device)
    return FactorGraph(chain_prefix=int(chain_prefix), **out)


def from_dataset(
    data: Dict[str, np.ndarray],
    prior_sigma: float = 0.1,
    dtype=torch.float32,
    device="cuda",
) -> FactorGraph:
    """Build a FactorGraph on `device` from a g2o/synthetic dataset dict,
    anchoring node 0 with an isotropic prior. Same permutation and
    chain_prefix as the JAX from_dataset; the sqrt-information is factored
    in float64 numpy and then cast, as there."""
    edges = np.asarray(data["edges"], np.int32)
    meas = np.asarray(data["measurements"])
    info = np.asarray(data["information"])
    E = edges.shape[0]
    T = info.shape[-1]
    is_loop = np.asarray(
        data.get("is_loop", edges[:, 1] != edges[:, 0] + 1), bool
    )

    n_poses = np.asarray(data["poses"]).shape[0]
    perm, chain_prefix = _chain_reorder(edges, n_poses)
    edges = edges[perm]
    meas = meas[perm]
    info = info[perm]
    is_loop = is_loop[perm]

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    prior_info = np.eye(T)[None] / (prior_sigma**2)
    fields = {
        "edges": edges,
        "measurements": meas.astype(np_dtype),
        "sqrt_info": _chol_info(info).astype(np_dtype),
        "edge_mask": np.ones((E,), bool),
        "is_loop": is_loop,
        "prior_idx": np.zeros((1,), np.int32),
        "prior_meas": np.asarray(data["poses"])[0:1].astype(np_dtype),
        "prior_sqrt_info": _chol_info(prior_info).astype(np_dtype),
        "prior_mask": np.ones((1,), bool),
    }
    return from_numpy(fields, chain_prefix, device)
