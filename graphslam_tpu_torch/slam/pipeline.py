"""The SLAM step, scan in and updated map out: port of
graphslam_tpu/slam/pipeline.py.

One call covers the reference dataflow for a scan: projection, GICP against
the last keyframe, the loop probe, keyframe and factor commits, and the
periodic solve over the smallest power-of-two pose window covering the live
keyframes (the occupancy bucket), with the dense covariance refresh on loop
commits.

The JAX step is one jitted function whose branches are lax.cond and
lax.switch. Here the commits are masked writes on the device, exactly as
there, and the three branches are Python branches on flags read from the
device: two host reads per scan, one for `loop_plausible` after the
odometry match and one for (do_solve, bucket, do_cov) after the commit.
The fused GN kernel reads once more per solve (its node-id check).

The step updates the state's tensors in place and returns the same state
(the JAX step donates its state); start every replay from a fresh
`init_state`. Kernels follow the device: CUDA tensors go through the GICP
kernel (ops/icp_kernel.py) and the fused GN kernel (ops/gn_kernel.py); CPU
tensors through their plain twins. `make_slam_step(cfg, use_kernels=False)`
runs the plain twins on the card too, to time them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphslam_tpu_torch.config import SLAMConfig
from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.frontend.icp import MatchResult, gicp_match
from graphslam_tpu_torch.frontend.keyframes import motion_covariance
from graphslam_tpu_torch.frontend.projection import beam_angles, scan_to_points
from graphslam_tpu_torch.geometry import se2
from graphslam_tpu_torch.slam.state import SLAMState, init_state
from graphslam_tpu_torch.solver.lm import _gn_loop, _solve_mode

_DENSE_COV_MAX = 2048  # pipeline.py:467: the dense marginals up to this bucket


class StepInfo(NamedTuple):
    is_keyframe: torch.Tensor
    added_loop: torch.Tensor
    fitness: torch.Tensor
    delta: torch.Tensor
    num_kf: torch.Tensor
    num_factors: torch.Tensor
    # Capacity exhausted: commits stop rather than corrupting slots.
    at_capacity: torch.Tensor


def graph_view(
    state: SLAMState,
    cfg: SLAMConfig,
    size: Optional[int] = None,
    loop_size: Optional[int] = None,
) -> FactorGraph:
    """A FactorGraph over the first `size` pose slots (default: capacity).

    Chain factors fill the first size-1 edge slots as literal (k, k+1) pairs
    (chain_prefix applies). Inactive poses (index >= num_kf) get identity
    priors at their current values: zero residual, but the masked normal
    equations stay nonsingular. loop_size restricts the view to the first
    loop slots, exact while num_loops <= loop_size.
    """
    K = state.kf_poses.shape[0] if size is None else size
    dtype, dev = state.kf_poses.dtype, state.device
    idx = torch.arange(K, device=dev)
    first = idx == 0
    eye = torch.eye(3, dtype=dtype, device=dev)
    prior_sqrt = torch.where(first[:, None, None], eye / cfg.prior_sigma_xy, eye.expand(K, 3, 3))
    prior_meas = torch.where(first[:, None], state.anchor, state.kf_poses[:K])

    c = K - 1
    chain_edges = torch.stack([idx[:c], idx[1:]], dim=1).to(torch.int32)
    F = state.loop_edges.shape[0] if loop_size is None else loop_size
    # Masked slots past num_loops have zero residual and Jacobian; clipping
    # keeps their endpoints inside the window.
    loop_edges = torch.clamp(state.loop_edges[:F], max=K - 1)
    return FactorGraph(
        chain_prefix=c,
        edges=torch.cat([chain_edges, loop_edges], dim=0),
        measurements=torch.cat([state.chain_meas[:c], state.loop_meas[:F]], dim=0),
        sqrt_info=torch.cat([state.chain_sqrt_info[:c], state.loop_sqrt_info[:F]], dim=0),
        edge_mask=torch.cat([state.chain_mask[:c], state.loop_mask[:F]], dim=0),
        is_loop=torch.cat([torch.zeros(c, dtype=torch.bool, device=dev),
                           torch.ones(F, dtype=torch.bool, device=dev)]),
        prior_idx=idx.to(torch.int32),
        prior_meas=prior_meas,
        prior_sqrt_info=prior_sqrt,
        prior_mask=first | (idx >= state.num_kf),
    )


def _solve_buckets(capacity: int, min_bucket: int):
    """Static power-of-two pose-window sizes covering [min_bucket, capacity]."""
    sizes = []
    b = min(min_bucket, capacity)
    while b < capacity:
        sizes.append(b)
        b *= 2
    sizes.append(capacity)
    return sizes


def _m33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 product in full float32. The JAX package pins HIGHEST precision
    because the TPU's default is bf16; the port keeps TF32 off for the same
    reason (graphslam_tpu_torch/__init__.py)."""
    return a @ b


def _sqrt_info_from_cov(cov: torch.Tensor) -> torch.Tensor:
    """Sqrt-information U with U^T U = cov^-1 (U = L^-1, L the Cholesky factor)."""
    # Symmetrize + trace-scaled ridge: an indefinite input would NaN the
    # Cholesky and poison the graph downstream.
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    cov = cov + (1e-6 * torch.abs(tr) + 1e-9)[..., None, None] * eye
    L = torch.linalg.cholesky_ex(cov)[0]
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _factor_covariance(res: MatchResult, delta, fcfg, use_match, mc=None):
    """Measurement covariance of a committed factor.

    A trusted match gives s * H^-1 (the GICP Fisher information, scaled by
    s = max(mahal_rmse^2 / 2, 1)) plus a fraction of the motion model; a
    rejected one the motion model alone. `mc` overrides the motion model
    (the pipeline passes the transported interval covariance)."""
    if mc is None:
        mc = motion_covariance(delta, fcfg)
    if not fcfg.use_match_covariance:
        return mc
    s = torch.clamp(res.mahal_rmse**2 / 2.0, min=1.0)
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    cov_match = s * torch.linalg.inv_ex(res.hessian + 1e-8 * eye)[0]
    cov_match = cov_match + fcfg.match_cov_motion_floor * mc + 1e-8 * eye
    cov_match = 0.5 * (cov_match + cov_match.T)
    return torch.where(use_match, cov_match, mc)


def _skip_probe(dtype, dev) -> MatchResult:
    """The loop probe's result when no candidate is plausible (pipeline.py:287)."""
    f = torch.zeros((), dtype=dtype, device=dev)
    return MatchResult(
        delta=torch.zeros(3, dtype=dtype, device=dev), fitness=f, inlier_rms=f + 1e9,
        matched_frac=f, converged=torch.zeros((), dtype=torch.bool, device=dev),
        mahal_rmse=f + 1e9, degenerate=torch.ones((), dtype=torch.bool, device=dev),
        hessian=torch.eye(3, dtype=dtype, device=dev),
    )


def _match_ok(res: MatchResult, fcfg) -> torch.Tensor:
    return (res.converged & (res.matched_frac > 0.5)
            & (res.inlier_rms < fcfg.max_match_rmse) & ~res.degenerate)


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a (1,) index tensor, without a host read."""
    return x.index_select(0, i)[0]


def _put_row(x: torch.Tensor, i: torch.Tensor, cond: torch.Tensor, val) -> None:
    """x[i] = where(cond, val, x[i]) in place: the masked write of
    `.at[i].set(where(...))`."""
    x.index_copy_(0, i, torch.where(cond, val, _row(x, i))[None])


def make_slam_step(cfg: SLAMConfig, use_kernels: Optional[bool] = None):
    """Build the step: (state, ranges, odom_delta[, odom_cov]) -> (state, info).

    use_kernels: None runs the CUDA kernels for CUDA tensors and the plain
    twins for CPU tensors; False runs the plain twins on either device."""
    fcfg = cfg.frontend
    scfg = cfg.solver
    if cfg.warm_start_solves and not scfg.cg_warm_start:
        # Online solves refine poses that persist across solves: seed each
        # GN iteration's CG from the previous dx inside the fused kernel.
        scfg = dataclasses.replace(scfg, cg_warm_start=True)
    buckets = _solve_buckets(cfg.max_keyframes, cfg.solve_bucket_min)
    Fc = min(cfg.cov_loop_window, cfg.max_factors)
    if cfg.cov_every and buckets[-1] > _DENSE_COV_MAX:
        raise NotImplementedError(
            f"covariances for a {buckets[-1]}-keyframe window need "
            "marginal_covariances_all, not ported yet (ROADMAP.md Queue 1, item 10)"
        )
    consts = {}  # per device: beam angles and the first keyframe's covariance

    def match(s, sm, t, tm, init):
        return gicp_match(
            s, sm, t, tm,
            init_delta=init,
            iterations=fcfg.icp_iterations,
            max_corr_dist=fcfg.max_correspondence_distance,
            half_window=fcfg.normal_half_window,
            gicp_eps=fcfg.gicp_epsilon,
            use_kernel=use_kernels,
        )

    def solve(poses0: torch.Tensor, graph: FactorGraph) -> torch.Tensor:
        mode = _solve_mode(scfg, poses0.shape[0])
        return _gn_loop(poses0, graph, scfg, mode, cfg.solve_iterations,
                        use_kernel=use_kernels is not False)

    def step(
        state: SLAMState,
        ranges: torch.Tensor,
        odom_delta: torch.Tensor,
        odom_cov: Optional[torch.Tensor] = None,
    ):
        dtype, dev = state.kf_poses.dtype, state.device
        Kcap, F = state.kf_poses.shape[0], state.loop_edges.shape[0]
        if dev not in consts:
            sxy2, sth2 = cfg.prior_sigma_xy**2, cfg.prior_sigma_theta**2
            consts[dev] = (beam_angles(fcfg.num_beams, fcfg.fov_rad, dtype, dev),
                           torch.diag(torch.tensor([sxy2, sxy2, sth2], dtype=dtype, device=dev)))
        angles, prior_cov = consts[dev]
        pts, mask = scan_to_points(ranges, angles, fcfg.min_range, fcfg.max_range,
                                   fcfg.max_points)
        num_kf, num_loops = state.num_kf, state.num_loops
        first = num_kf == 0
        last_idx = torch.clamp(num_kf - 1, min=0).long().reshape(1)
        last_pose = _row(state.kf_poses, last_idx)
        zero3 = torch.zeros(3, dtype=dtype, device=dev)

        # Odometry since the last keyframe (the ICP prior and the fallback
        # factor), its covariance transported by the interval adjoint.
        odom_acc = se2.compose(state.odom_accum, odom_delta)
        q_step = motion_covariance(odom_delta, fcfg)
        if odom_cov is not None:
            q_step = torch.where(torch.any(odom_cov != 0), odom_cov, q_step)
        Ad_od = se2.adjoint(se2.inverse(odom_delta))
        cov_acc = _m33(_m33(Ad_od, state.odom_cov_accum), Ad_od.T) + q_step

        # Loop candidate: the nearest eligible keyframe to the pose guess.
        pose_guess = se2.compose(last_pose, odom_acc)
        kidx = torch.arange(Kcap, device=dev)
        d2 = torch.sum((state.kf_poses[:, :2] - pose_guess[:2]) ** 2, dim=-1)
        d2 = torch.where(kidx < num_kf - cfg.loop_closure_skip, d2,
                         torch.full_like(d2, float("inf")))
        cand_idx = torch.argmin(d2).reshape(1)
        cand_dist = torch.sqrt(_row(d2, cand_idx))
        cand_pose = _row(state.kf_poses, cand_idx)

        # GICP against the last keyframe, or the last L keyframes' points in
        # the last keyframe's frame (scan-to-map).
        L = cfg.scan_to_map_keyframes
        if L > 1:
            offs = torch.arange(L, device=dev)
            src_idx = torch.clamp(num_kf - 1 - offs, 0, Kcap - 1).long()
            rel = se2.between(last_pose.expand(L, 3), state.kf_poses[src_idx])
            tgt_pts = se2.transform(rel, state.kf_points[src_idx]).reshape(-1, 2)
            tgt_mask = (state.kf_masks[src_idx] & (offs < num_kf)[:, None]).reshape(-1)
        else:
            tgt_pts = _row(state.kf_points, last_idx)
            tgt_mask = _row(state.kf_masks, last_idx)
        res_odo = match(pts, mask, tgt_pts, tgt_mask, odom_acc)
        odo_ok = _match_ok(res_odo, fcfg)

        # Loop probe only when a candidate is plausible: host read 1.
        loop_init = se2.between(cand_pose, pose_guess)
        loop_plausible = torch.isfinite(cand_dist) & (cand_dist < cfg.loop_closure_max_distance)
        if bool(loop_plausible):
            res_loop = match(pts, mask, _row(state.kf_points, cand_idx),
                             _row(state.kf_masks, cand_idx), loop_init)
        else:
            res_loop = _skip_probe(dtype, dev)
        loop_ok = _match_ok(res_loop, fcfg)

        # An unreliable match falls back to raw odometry for the factor; the
        # motion gate runs on that effective delta.
        delta = torch.where(odo_ok, res_odo.delta, odom_acc)
        moved_enough = (
            (odo_ok & (res_odo.fitness > fcfg.keyframe_fitness_threshold))
            | (torch.linalg.vector_norm(delta[:2]) > fcfg.keyframe_trans_threshold)
            | (torch.abs(delta[2]) > fcfg.keyframe_rot_threshold)
        )
        at_capacity = (num_kf >= Kcap) | (num_loops >= F - 1)
        is_kf = (first | moved_enough) & ~at_capacity
        new_pose = torch.where(first, zero3, se2.compose(last_pose, delta))
        do_loop = is_kf & ~first & (cand_dist < cfg.loop_closure_max_distance) & loop_ok

        # Factor noise, and the fresh keyframe's transported covariance (the
        # first keyframe gets the prior's).
        add_odo = is_kf & ~first
        cov = _factor_covariance(res_odo, delta, fcfg, odo_ok, mc=cov_acc)
        si = _sqrt_info_from_cov(cov)
        Ad = se2.adjoint(se2.inverse(delta))
        prop_cov = _m33(_m33(Ad, _row(state.kf_covs, last_idx)), Ad.T) + cov
        loop_si = _sqrt_info_from_cov(_factor_covariance(res_loop, res_loop.delta, fcfg, loop_ok))

        # Commit: masked writes into the keyframe, chain and loop slots.
        ki = torch.clamp(num_kf, max=Kcap - 1).long().reshape(1)
        _put_row(state.kf_poses, ki, is_kf, new_pose)
        _put_row(state.kf_points, ki, is_kf, pts)
        _put_row(state.kf_masks, ki, is_kf, mask)
        _put_row(state.kf_covs, ki, is_kf, torch.where(first, prior_cov, prop_cov))
        _put_row(state.chain_meas, last_idx, add_odo, delta)
        _put_row(state.chain_sqrt_info, last_idx, add_odo, si)
        _put_row(state.chain_mask, last_idx, add_odo, torch.ones_like(add_odo))
        f1 = torch.clamp(num_loops, max=F - 1).long().reshape(1)
        _put_row(state.loop_edges, f1, do_loop, torch.cat([cand_idx, ki]).to(torch.int32))
        _put_row(state.loop_meas, f1, do_loop, res_loop.delta)
        _put_row(state.loop_sqrt_info, f1, do_loop, loop_si)
        _put_row(state.loop_mask, f1, do_loop, torch.ones_like(do_loop))
        num_kf = num_kf + is_kf.to(torch.int32)
        num_loops = num_loops + do_loop.to(torch.int32)
        state.num_kf.copy_(num_kf)
        state.num_loops.copy_(num_loops)
        state.odom_accum.copy_(torch.where(is_kf, zero3, odom_acc))
        state.odom_cov_accum.copy_(torch.where(is_kf, torch.zeros_like(cov_acc), cov_acc))

        # Periodic solve over the occupancy bucket, and the dense covariance
        # refresh (on loop commits by default): host read 2.
        do_solve = is_kf & (num_kf % cfg.solve_every == 0) & (num_kf > 1)
        bidx = sum((num_kf > b).to(torch.int32) for b in buckets[:-1]) if len(buckets) > 1 \
            else torch.zeros((), dtype=torch.int32, device=dev)
        want_cov = do_loop if cfg.cov_on_loop_only else (num_kf % max(cfg.cov_every, 1) == 0)
        do_cov = want_cov & (num_loops <= Fc)
        solve_now, b, cov_now = torch.stack(
            [do_solve.to(torch.int32), bidx, do_cov.to(torch.int32)]).tolist()
        if solve_now:
            B = buckets[b]
            state.kf_poses[:B] = solve(state.kf_poses[:B], graph_view(state, cfg, B))
            if cfg.cov_every and cov_now:
                from graphslam_tpu_torch.solver.marginals import marginal_covariances_dense

                gcov = graph_view(state, cfg, B, loop_size=Fc)
                state.kf_covs[:B] = marginal_covariances_dense(state.kf_poses[:B], gcov)

        info = StepInfo(
            is_keyframe=is_kf,
            added_loop=do_loop,
            fitness=res_odo.fitness,
            delta=delta,
            num_kf=num_kf,
            num_factors=torch.clamp(num_kf - 1, min=0) + num_loops,
            at_capacity=at_capacity,
        )
        return state, info

    return step


def state_to_dataset(state: SLAMState) -> dict:
    """Export the online map as the standard dataset dict (keyframe poses
    and committed factors only)."""
    n = int(state.num_kf)
    nl = int(state.num_loops)
    c = max(n - 1, 0)
    chain_edges = np.stack([np.arange(c), np.arange(1, n)], axis=1).astype(np.int32) \
        if c else np.zeros((0, 2), np.int32)
    f = {k: getattr(state, k).cpu().numpy() for k in (
        "loop_edges", "chain_meas", "loop_meas", "chain_sqrt_info", "loop_sqrt_info",
        "kf_poses", "kf_covs")}
    sqrt_info = np.concatenate([f["chain_sqrt_info"][:c], f["loop_sqrt_info"][:nl]], axis=0)
    return {
        "dim": 2,
        "poses": f["kf_poses"][:n],
        "covariances": f["kf_covs"][:n],
        "edges": np.concatenate([chain_edges, f["loop_edges"][:nl]], axis=0),
        "measurements": np.concatenate([f["chain_meas"][:c], f["loop_meas"][:nl]], axis=0),
        "information": np.einsum("eba,ebc->eac", sqrt_info, sqrt_info),
        "is_loop": np.concatenate([np.zeros(c, bool), np.ones(nl, bool)]),
    }


def make_slam_replay(cfg: SLAMConfig, num_steps: int, use_kernels: Optional[bool] = None):
    """Whole-replay entry point: (state, scans (T, B), odom (T, 3)[, odom_covs])
    -> (state, StepInfo of stacked (T, ...) tensors). The scans and odometry
    stay on the state's device; the loop over scans runs on the host."""
    step = make_slam_step(cfg, use_kernels)

    def replay(state: SLAMState, scans: torch.Tensor, odom: torch.Tensor,
               odom_covs: Optional[torch.Tensor] = None):
        infos = []
        for t in range(num_steps):
            state, info = step(state, scans[t], odom[t],
                               None if odom_covs is None else odom_covs[t])
            infos.append(info)
        return state, StepInfo(*(torch.stack(x) for x in zip(*infos)))

    return replay


def run_slam_scan(scans: np.ndarray, odom_deltas: Optional[np.ndarray], cfg: SLAMConfig,
                  device="cuda"):
    """Replay a whole run on `device`; returns (state, stacked infos)."""
    T = scans.shape[0]
    odom = np.zeros((T, 3), np.float32)
    if odom_deltas is not None:
        odom[1:] = odom_deltas[: T - 1]
    state = init_state(cfg, device=device)
    return make_slam_replay(cfg, T)(
        state, torch.from_numpy(np.asarray(scans, np.float32)).to(device),
        torch.from_numpy(odom).to(device),
    )


def run_slam(scans: np.ndarray, odom_deltas: Optional[np.ndarray], cfg: SLAMConfig,
             device="cuda"):
    """Feed every scan through the step on `device`. Returns (final_state,
    list of StepInfo of numpy values), as the JAX run_slam does."""
    step = make_slam_step(cfg)
    state = init_state(cfg, device=device)
    infos = []
    zeros = torch.zeros(3, dtype=state.kf_poses.dtype, device=device)
    for t in range(scans.shape[0]):
        od = zeros if odom_deltas is None or t == 0 else \
            torch.tensor(np.asarray(odom_deltas[t - 1], np.float32), device=device)
        ranges = torch.tensor(np.asarray(scans[t], np.float32), device=device)
        state, info = step(state, ranges, od)
        infos.append(StepInfo(*(x.cpu().numpy() for x in info)))
    return state, infos
