"""Nearest valid target (K8): hand-written CUDA kernel and plain twin.

Replaces graphslam_tpu/ops/correspondence.py::_nn_kernel, the Pallas kernel
behind `nearest_neighbors`: for every source point, the index and squared
distance of the nearest valid target, without the (P, Q) distance matrix
leaving the chip. It is K2's first stage; the kernel (`k_nn` in
csrc/icp_kernel.cu, one launch a call) runs K2's device routine
(`group_nearest`): a group of threads a source point scans the targets
staged in shared memory on exact coordinate differences, each product and
sum rounded on its own, so its distances equal the twin's bit for bit. Ties
go to the lowest index, as argmin's do; invalid targets read +inf, so with
none valid the index is 0 and the distance inf.

`nearest_neighbors` takes the twin only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises, and counts successful launches
in `.launches`. `nearest_neighbors_serial` runs the shape the kernel
replaced (one thread a point), bitwise equal: a yardstick, not counted and
never on the path.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch


def nearest_neighbors_reference(src, tgt, tgt_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P,2),(Q,2),(Q,) -> (nn_idx (P,) int32, nn_d2 (P,)), exact
    coordinate differences (never the ||a||^2+||b||^2-2ab product form)."""
    dx = src[:, 0:1] - tgt[None, :, 0]
    dy = src[:, 1:2] - tgt[None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = torch.where(tgt_valid[None, :], d2, torch.full_like(d2, float("inf")))
    idx = torch.argmin(d2, dim=1)
    return idx.to(torch.int32), torch.gather(d2, 1, idx[:, None])[:, 0]


def nearest_neighbors(src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor):
    """Same contract as nearest_neighbors_reference: the CUDA kernel for
    CUDA tensors, the twin for CPU tensors."""
    if src.device.type == "cpu":
        return nearest_neighbors_reference(src, tgt, tgt_valid)
    if src.device.type != "cuda":
        raise ValueError(f"nearest_neighbors needs CPU or CUDA tensors, got {src.device}")
    out = _search("nn_search", src, tgt, tgt_valid)
    nearest_neighbors.launches += 1
    return out


def nearest_neighbors_serial(src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor):
    """K8 in the shape the kernel replaced (`nn_search_serial`: one thread a
    point scanning every target), bitwise equal to it: the yardstick of
    checks and timings, never on the path. CUDA tensors only."""
    return _search("nn_search_serial", src, tgt, tgt_valid)


def _search(fn: str, src, tgt, tgt_valid):
    """(idx, d2) of the C entry fn of csrc/icp_kernel.cu on CUDA tensors;
    raises on a CUDA error."""
    from graphslam_tpu_torch.ops.icp_kernel import _check, _lib, _raise_on

    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")
    P, Q = src.shape[0], tgt.shape[0]
    if P < 1 or Q < 1:
        raise ValueError(f"need at least one source and one target point, got P={P}, Q={Q}")
    src = _check("src", src, torch.float32, (P, 2), dev)
    tgt = _check("tgt", tgt, torch.float32, (Q, 2), dev)
    valid = _check("tgt_valid", tgt_valid, torch.bool, (Q,), dev)
    idx = torch.empty(P, dtype=torch.int32, device=dev)
    d2 = torch.empty(P, dtype=torch.float32, device=dev)
    rc = getattr(_lib(), fn)(src.data_ptr(), tgt.data_ptr(), valid.data_ptr(), idx.data_ptr(),
                             d2.data_ptr(), P, Q,
                             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, fn)
    return idx, d2


nearest_neighbors.launches = 0
