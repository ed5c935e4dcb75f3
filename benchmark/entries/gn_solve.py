"""solver/lm.py::gn_solve: a fixed number of GN iterations (mode gn_fused: K1 or K4)."""

from __future__ import annotations


def setup(mix, data, device):
    from graphslam_tpu_torch.config import SolverConfig

    return {"cfg": SolverConfig(**mix["solver"]), "iterations": int(mix["iterations"]),
            "device": device}


def request(st, data, rec):
    import torch

    from graphslam_tpu_torch.factors.graph import from_dataset
    from graphslam_tpu_torch.solver.lm import gn_solve

    with rec.span("host_entry"):
        with rec.span("from_dataset"):
            graph = from_dataset(data, device=st["device"])
            p0 = torch.from_numpy(data["poses"]).to(st["device"])
        with rec.span("entry"):
            poses = gn_solve(p0, graph, st["cfg"], iterations=st["iterations"])
    with rec.span("read"):
        return {"poses": poses.cpu().numpy()}
