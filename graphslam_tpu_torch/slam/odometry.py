"""Odometry motion model: twist integration + time-indexed ring buffer.
Port of graphslam_tpu/slam/odometry.py.

The reference's odometry node was dead code: its integration body was
commented out and the executable never built (odometry.cpp:139-206,
CMakeLists.txt:21-23; SURVEY.md §3.4). This implements the *intended*
semantics: integrate /cmd_vel twists into a pose with a motion-scaled
covariance (k_disp_disp/k_rot_disp/k_rot_rot model, odometry.cpp:23), keep a
fixed-depth ring buffer of stamped poses (odometry.cpp:74's 1000-deep deque),
and serve relative-pose deltas over a time interval (odometry.cpp:84-116's
OdometryBuffer service, with nearest-timestamp lookup instead of the
reference's whole-second integer matching bug).

`integrate_twist` writes the tick into the buffer's ring in place and
returns the buffer with its new head, pose and covariance (the pipeline's
step updates its state in place too); no host read. `query_interval`
takes scalar stamps or (I,) stamps, answering I intervals at once.
"""

from __future__ import annotations

import dataclasses

import torch

from graphslam_tpu_torch.config import FrontendConfig
from graphslam_tpu_torch.frontend.keyframes import motion_covariance
from graphslam_tpu_torch.geometry import se2

BUFFER_DEPTH = 1000  # odometry.cpp:74


@dataclasses.dataclass(frozen=True)
class OdometryBuffer:
    times: torch.Tensor   # (B,)
    poses: torch.Tensor   # (B, 3)
    covs: torch.Tensor    # (B, 3, 3) body-frame covariance at each stamp
    valid: torch.Tensor   # (B,)
    head: torch.Tensor    # () int32 next write slot
    pose: torch.Tensor    # (3,) current integrated pose
    cov: torch.Tensor     # (3, 3) accumulated covariance

    def replace(self, **kw) -> "OdometryBuffer":
        return dataclasses.replace(self, **kw)


def init_buffer(depth: int = BUFFER_DEPTH, dtype=torch.float32, device="cuda") -> OdometryBuffer:
    """An empty buffer of `depth` stamps on `device`."""
    return OdometryBuffer(
        times=torch.full((depth,), -float("inf"), dtype=dtype, device=device),
        poses=torch.zeros((depth, 3), dtype=dtype, device=device),
        covs=torch.zeros((depth, 3, 3), dtype=dtype, device=device),
        valid=torch.zeros((depth,), dtype=torch.bool, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
        pose=torch.zeros((3,), dtype=dtype, device=device),
        cov=torch.zeros((3, 3), dtype=dtype, device=device),
    )


def integrate_twist(
    buf: OdometryBuffer,
    twist: torch.Tensor,  # (3,) [vx, vy, omega] body frame
    dt,
    t,
    cfg: FrontendConfig = FrontendConfig(),
) -> OdometryBuffer:
    """One integration tick (the odometry.cpp:139-206 loop body, enabled)."""
    delta = twist * dt
    new_pose = se2.compose(buf.pose, delta)
    # Covariance transported through the motion and grown by the step model:
    # C_{t+1} = Ad(delta)^{-1} C_t Ad(delta)^{-T} + Q_step, with Ad the GROUP
    # adjoint of the relative pose applied in `compose` above (the adjoint is
    # a homomorphism, so interval transports compose exactly; see
    # query_interval). Full float32 products: TF32 is off (package import).
    Ad_inv = se2.adjoint(se2.inverse(delta))
    grown = (Ad_inv @ buf.cov) @ Ad_inv.T + motion_covariance(delta, cfg)
    h = torch.remainder(buf.head, buf.times.shape[0]).long().reshape(1)
    buf.times.index_copy_(0, h, torch.as_tensor(t, dtype=buf.times.dtype,
                                                device=buf.times.device).reshape(1))
    buf.poses.index_copy_(0, h, new_pose[None])
    buf.covs.index_copy_(0, h, grown[None])
    buf.valid.index_fill_(0, h, True)
    return buf.replace(head=buf.head + 1, pose=new_pose, cov=grown)


def _entry_at(buf: OdometryBuffer, t):
    """(pose, covariance) at the buffered timestamp nearest to t (scalar or
    (I,) stamps); the first of equally near ones, as argmin takes it."""
    t = torch.as_tensor(t, dtype=buf.times.dtype, device=buf.times.device)
    dt = torch.where(buf.valid, torch.abs(buf.times - t[..., None]),
                     torch.full((), float("inf"), dtype=buf.times.dtype,
                                device=buf.times.device))
    k = torch.argmin(dt, dim=-1)
    return buf.poses[k], buf.covs[k]


def query_interval(
    buf: OdometryBuffer,
    t_start,
    t_end,
    cfg: FrontendConfig = FrontendConfig(),
):
    """Relative pose and TRANSPORTED covariance between the buffered poses
    nearest to t_start and t_end: the OdometryBuffer.srv contract
    (odometry.cpp:84-116's intended semantics).

    The per-entry covariances follow C_b = Ad(delta)^{-1} C_a Ad(delta)^{-T}
    + Q_ab (integrate_twist), so the noise accumulated strictly inside the
    interval is recovered exactly:  Q_ab = C_b - Ad(D)^{-1} C_a Ad(D)^{-T}
    with D = between(a, b). Symmetrized with a small PSD floor against f32
    rounding; the floor's smallest eigenvalues come from one batched
    eigvalsh over every interval."""
    a, Ca = _entry_at(buf, t_start)
    b, Cb = _entry_at(buf, t_end)
    delta = se2.between(a, b)
    Ad_inv = se2.adjoint(se2.inverse(delta))
    Q = Cb - (Ad_inv @ Ca) @ Ad_inv.transpose(-1, -2)
    Q = 0.5 * (Q + Q.transpose(-1, -2))
    # PSD floor: rounding (or a query straddling the ring-buffer overwrite
    # horizon) can leave a slightly indefinite difference.
    eigmin = torch.linalg.eigvalsh(Q).min(dim=-1).values
    eye = torch.eye(3, dtype=Q.dtype, device=Q.device)
    Q = Q + (torch.clamp(-eigmin, min=0.0) + 1e-12)[..., None, None] * eye
    return delta, Q
