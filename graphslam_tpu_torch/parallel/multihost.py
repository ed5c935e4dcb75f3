"""Multi-process bring-up on torch.distributed: port of graphslam_tpu/parallel/multihost.py.

The reference relied on rosmaster for discovery and roslaunch for process
supervision (SURVEY.md §5.8). Here every process runs the SAME program, one
process per rank, and `initialize()` joins them into one process group; the
factor-sharded solvers (parallel/dist.py, parallel/dist_fused.py) then run
unchanged over `global_mesh()`.

Typical use, one process per GPU:

    from graphslam_tpu_torch.parallel import multihost
    multihost.initialize()                 # MASTER_ADDR/PORT, RANK, WORLD_SIZE
    mesh = multihost.global_mesh()         # every rank of every host
    poses = dist_fused_gn_solve(poses0, graph, mesh, cfg)

A single process needs neither: `make_mesh()` creates a one-rank group.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from graphslam_tpu_torch.parallel.dist import Mesh, default_backend, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to the job's process group.

    With no arguments everything comes from the environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets them); explicit
    arguments name the coordinator ("host:port"), the process count and
    this process's rank. The backend is NCCL for a cuda `device` (the
    default) and gloo for cpu, unless `backend` names one: gloo also
    all-reduces CUDA tensors, which lets two ranks share one card."""
    device = torch.device(device if device is not None else "cuda")
    kw = {}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", device.index or 0)))
    dist.init_process_group(backend or default_backend(device), **kw)


def global_mesh(axis: str = "dev", device=None) -> Mesh:
    """One mesh axis over every rank of the process group."""
    return make_mesh(axis=axis, device=device)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
