"""The comparison that decides `correct`: every answer of the window against
the reference's solve of the same map.

Numbers, each for one answer (the run reports the worst over its answers):
  cost_gap     |F(x) - F(x_ref)| / F(x_ref), F the map's cost in float64
               (Huber on the loops where the mix uses it), x the answer's
               poses, x_ref the reference's;
  error_gap    |e - F(x_ref)| / F(x_ref), e the cost the answer reports;
  error_self_gap  |e - F(x)| / F(x): the reported cost against the cost
               of the answer's own poses;
  accepted_gap |accepted steps - the reference's|;
  pose_gap_m   the largest distance between an answer's pose and the
               reference's, in metres;
  aligned_gap_m  the same after the rigid motion that best fits the
               answer's positions onto the reference's (the map's global
               placement is held only by the weak prior on pose 0);
  rot_gap_rad  the largest angle between an answer's orientation and the
               reference's;
  aligned_rot_gap_rad  the same after the answer's orientations are turned
               by the rotation of that fit.
A cell compares those its `cells/<name>.json` gives a limit; the others are
printed for information. A number that is not finite fails its limit.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from benchmark.reference.lie import group


def digest(answer: dict) -> str:
    """Answers with the same bytes are judged once."""
    h = hashlib.sha256()
    for k in sorted(answer):
        v = answer[k]
        h.update(k.encode() + np.ascontiguousarray(v).tobytes() if isinstance(v, np.ndarray)
                 else k.encode() + repr(v).encode())
    return h.hexdigest()


def _fit(a: np.ndarray, b: np.ndarray):
    """(M, gap): the least-squares rotation M and shift s that take the
    positions a_k onto b_k, and max |M a_k + s - b_k|; (None, inf) where
    either holds a number that is not finite."""
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return None, float("inf")
    ca, cb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((a - ca).T @ (b - cb))
    d = np.ones(a.shape[1])
    d[-1] = np.sign(np.linalg.det(U @ Vt))
    R = (U * d) @ Vt
    return R.T, float(np.linalg.norm((a - ca) @ R - (b - cb), axis=1).max())


def numbers(answer: dict, ref: dict, cost_of) -> dict:
    """The numbers of one answer against the reference's result `ref`
    ({"poses", "cost", "accepted"}); `cost_of(poses)` is the float64 cost."""
    x = np.asarray(answer["poses"], np.float64)
    xr = np.asarray(ref["poses"], np.float64)
    G = group(x.shape[-1])
    xt, xrt = torch.from_numpy(x), torch.from_numpy(xr)
    fx = cost_of(x)
    M, aligned = _fit(G.translation(xt).numpy(), G.translation(xrt).numpy())
    out = {
        "cost_gap": abs(fx - ref["cost"]) / ref["cost"],
        "pose_gap_m": float((G.translation(xt) - G.translation(xrt)).norm(dim=-1).max()),
        "rot_gap_rad": float(G.rotation_gap(xt, xrt).max()),
        "aligned_gap_m": aligned,
        "aligned_rot_gap_rad": float("inf") if M is None else
        float(G.rotation_gap(G.turned(torch.from_numpy(M), xt), xrt).max()),
    }
    if "error" in answer:
        out["error_gap"] = abs(answer["error"] - ref["cost"]) / ref["cost"]
        out["error_self_gap"] = abs(answer["error"] - fx) / fx
    if "accepted" in answer:
        out["accepted_gap"] = float(abs(answer["accepted"] - ref["accepted"]))
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}


def within(nums: dict, limits: dict) -> bool:
    return all(nums.get(k, float("inf")) <= lim for k, lim in limits.items())
