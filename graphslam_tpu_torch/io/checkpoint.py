"""Checkpoint / resume for SLAM state and pose graphs; port of
graphslam_tpu/io/checkpoint.py.

The reference had none: all state lived in process globals and died with the
process (graph.cpp:5-10, SURVEY.md §5). Every state object here is a
dataclass of tensors, so a checkpoint is one npz write. The file format is
the JAX package's: one array a tensor field, keyed by the field's name, in
the tensor's dtype (float32, int32, bool); fields that are not tensors (the
JAX package's static fields) are left out. A file written by either package
loads in the other.

One field is recovered on load rather than stored: a FactorGraph's
`chain_prefix`, the length of the leading run of edges (k, k+1). The JAX
package drops it (a static field) and reloads its graphs with 0, which its
fused GN kernel cannot run; here a reloaded graph runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.factors.graph import from_numpy as _graph_from_numpy
from graphslam_tpu_torch.slam.state import SLAMState
from graphslam_tpu_torch.slam.state import from_numpy as _state_from_numpy


def _flatten(state) -> Dict[str, np.ndarray]:
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state) if isinstance(getattr(state, f.name), torch.Tensor)}


def save_state(path: str, state: Any) -> None:
    """Write any dataclass of tensors (SLAMState, FactorGraph,
    OdometryBuffer, ...) to npz."""
    np.savez_compressed(path, **_flatten(state))


def chain_prefix_of(edges: np.ndarray) -> int:
    """The length of the leading run of edges with edges[k] == (k, k+1): the
    odometry chain that `from_dataset` put first (its `_chain_reorder` stops
    the chain at the first k without a (k, k+1) edge, so no later edge
    lengthens the run)."""
    e = np.asarray(edges).reshape(-1, 2)
    k = np.arange(e.shape[0])
    ok = (e[:, 0] == k) & (e[:, 1] == k + 1)
    return int(e.shape[0]) if ok.all() else int(np.argmin(ok))


def load_slam_state(path: str, device="cuda") -> SLAMState:
    """A SLAMState from a checkpoint, on `device`."""
    with np.load(path) as z:
        return _state_from_numpy({k: z[k] for k in z.files}, device=device)


def load_factor_graph(path: str, device="cuda") -> FactorGraph:
    """A FactorGraph from a checkpoint, on `device`, with its chain_prefix
    recovered from the edges (`chain_prefix_of`)."""
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    return _graph_from_numpy(fields, chain_prefix_of(fields["edges"]), device=device)
