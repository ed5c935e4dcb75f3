"""parallel/dist_schur.py::dist_schur_gn_solve on a mesh of this process's
ranks (world size 1 here: NCCL on the card, gloo on the CPU), with the
plan (`solver/schur.py::schur_plan`) made for each request from the graph's
edges. A traced request drives the same pieces the solve runs,
`prepare_rank` and then `gn_iteration` once an iteration, so that the
stages can be timed at the iteration's `mark` hook."""

from __future__ import annotations


def setup(mix, data, device):
    from graphslam_tpu_torch.parallel.dist import make_mesh

    return {"mesh": make_mesh(device=device), "device": device, "blocks": int(mix["blocks"]),
            "iterations": int(mix["iterations"]), "lam": float(mix["lam"])}


def request(st, data, rec):
    import torch

    from graphslam_tpu_torch.factors.graph import from_dataset
    from graphslam_tpu_torch.parallel.dist_schur import (
        dist_schur_gn_solve, gn_iteration, prepare_rank)
    from graphslam_tpu_torch.solver.schur import schur_plan

    mesh, dev = st["mesh"], st["device"]
    with rec.span("host_entry"):
        with rec.span("from_dataset"):
            graph = from_dataset(data, device=dev)
            p0 = torch.from_numpy(data["poses"]).to(dev)
        with rec.span("schur_plan"):
            plan = schur_plan(graph.edges.cpu().numpy(), p0.shape[0], st["blocks"])
        with rec.span("entry"):
            if not rec.trace:
                poses = dist_schur_gn_solve(p0, graph, plan, mesh, iterations=st["iterations"],
                                            lam=st["lam"])
            else:
                with rec.span("schur_prepare"):
                    sh = prepare_rank(graph, plan, mesh)
                lam = torch.as_tensor(st["lam"], dtype=p0.dtype, device=dev)
                poses = p0
                for _ in range(st["iterations"]):
                    rec.begin_iteration()
                    poses = gn_iteration(poses, sh, mesh, lam, mark=rec.mark)
    with rec.span("read"):
        out = {"poses": poses.cpu().numpy()}
    rec.settle()
    return out
