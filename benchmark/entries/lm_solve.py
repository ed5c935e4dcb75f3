"""solver/lm.py::lm_solve: the whole LM loop (mode gn_fused: K1-LM or K4-LM)."""

from __future__ import annotations


def setup(mix, data, device):
    from graphslam_tpu_torch.config import SolverConfig

    return {"cfg": SolverConfig(**mix["solver"]), "device": device}


def request(st, data, rec):
    import torch

    from graphslam_tpu_torch.factors.graph import from_dataset
    from graphslam_tpu_torch.solver.lm import lm_solve

    with rec.span("host_entry"):
        with rec.span("from_dataset"):
            graph = from_dataset(data, device=st["device"])
            p0 = torch.from_numpy(data["poses"]).to(st["device"])
        with rec.span("entry"):
            out = lm_solve(p0, graph, st["cfg"])
    with rec.span("read"):
        return {"poses": out.poses.cpu().numpy(), "error": float(out.error),
                "accepted": int(out.iterations)}
