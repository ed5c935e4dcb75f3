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


def carry_buffer(jbuf):
    """The port's OdometryBuffer holding a JAX OdometryBuffer's arrays."""
    import dataclasses

    import torch

    from graphslam_tpu_torch.slam.odometry import OdometryBuffer

    return OdometryBuffer(**{f.name: torch.from_numpy(np.array(getattr(jbuf, f.name)))
                             for f in dataclasses.fields(OdometryBuffer)})


def carry_grid(jgw):
    """The port's GridWorld holding a JAX GridWorld's arrays."""
    import torch

    from graphslam_tpu_torch.sim.grid import GridWorld

    return GridWorld(occ=torch.from_numpy(np.array(jgw.occ)), resolution=jgw.resolution,
                     origin=torch.from_numpy(np.array(jgw.origin)))


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


def run_ranks(world: int, scenario: str, out_dir, timeout: float = 240.0) -> dict:
    """Run tests/_torch_dist_worker.py SCENARIO in `world` gloo processes
    (one per rank, on the CPU) and return rank 0's saved arrays."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "_torch_dist_worker.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(str(out_dir), f"{scenario}_{world}.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(world), str(port), out, scenario],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=repo, env=env)
             for r in range(world)]
    try:
        results = [p.communicate(timeout=timeout) + (p.returncode,) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (stdout, stderr, rc) in enumerate(results):
        assert rc == 0, f"rank {rank} of {world} exited {rc}:\n{stderr[-3000:]}"
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def once_per_session(name: str, compute, tmp_path_factory):
    """compute() once per test session, also under pytest-xdist, where a
    module fixture otherwise runs again on every worker that draws one of
    its tests: the first worker to ask computes and pickles the value next
    to the workers' temporary directories, the others wait for it (a file
    lock) and load it. Without xdist it is compute()."""
    import fcntl
    import os
    import pickle

    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = compute()
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
