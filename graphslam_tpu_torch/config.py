"""Typed configuration, the port's copy of graphslam_tpu/config.py.

The four dataclasses keep the JAX package's field names and defaults
exactly (tests/test_torch_solver.py and tests/test_torch_pipeline.py check
it), so a config written for one package means the same for the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pose-graph optimizer settings (replaces gtsam LM defaults).

    `mode` selects the normal-equation solve:
      * "dense"     — dense Cholesky of the full (T*N, T*N) Hessian.
      * "pcg"       — matrix-free block-sparse preconditioned CG.
      * "gn_fused"  — the whole GN iteration (linearize, assemble, truncated
                      PCR preconditioner, fixed-count CG, retract) in the
                      hand-written CUDA kernel (ops/gn_kernel.py); its plain
                      torch twin runs for tensors on the CPU. SE(2) only.
      * "pcg_fused" — the fused whole-CG-loop kernel (ops/pcg_kernel.py,
                      K3) inside the GN and LM loops. SE(2) only.
      * "auto"      — dense below `dense_threshold` poses, else pcg.
    """

    mode: str = "auto"
    dense_threshold: int = 512

    # Levenberg-Marquardt schedule (GTSAM-like defaults).
    max_iterations: int = 100
    init_lambda: float = 1e-5
    lambda_factor: float = 10.0
    min_lambda: float = 1e-10
    max_lambda: float = 1e7
    rel_decrease_tol: float = 1e-6
    abs_decrease_tol: float = 1e-9

    # PCG settings. preconditioner: "tridiag" (cyclic-reduction solve of the
    # odometry-chain block-tridiagonal part, solver/tridiag.py) or "jacobi".
    cg_max_iterations: int = 250
    cg_tol: float = 1e-8
    preconditioner: str = "tridiag"

    # Huber kernel on loop-closure edges; delta in whitened-residual units.
    huber_delta: float = 1.0
    use_huber_on_loops: bool = False

    # Truncated PCR in the fused GN kernel: eliminate chain couplings only up
    # to distance 2^pcr_levels. None = the full ceil(log2 N) levels.
    pcr_levels: int | None = None

    # TPU layout knobs of the JAX kernels (loop-edge tile width and bf16
    # hi/lo splits of the CG matvec). Kept for config parity; the port
    # accepts and ignores both.
    edge_tile: int = 256

    # Warm-start CG inside the fused GN kernel from the previous GN step's dx.
    cg_warm_start: bool = False

    hvp_splits: int = 2

    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Scan-matching frontend settings (frontend/, sim/)."""

    num_beams: int = 1081
    fov_rad: float = 4.71716  # 270.25 deg
    max_range: float = 30.0
    min_range: float = 0.02
    max_points: int = 1152
    icp_iterations: int = 32
    max_correspondence_distance: float = 1.0
    gicp_epsilon: float = 1e-3
    normal_half_window: int = 4
    keyframe_fitness_threshold: float = 0.1
    keyframe_trans_threshold: float = 0.5
    keyframe_rot_threshold: float = 0.3
    max_match_rmse: float = 0.5
    k_disp_disp: float = 0.1
    k_rot_disp: float = 0.1
    k_rot_rot: float = 0.1
    use_match_covariance: bool = True
    match_cov_motion_floor: float = 0.01
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Online pipeline settings (slam/)."""

    max_keyframes: int = 1024
    max_factors: int = 4096
    prior_sigma_xy: float = 0.1
    prior_sigma_theta: float = 0.1
    loop_closure_skip: int = 10
    loop_closure_max_distance: float = 3.0
    solve_every: int = 1
    solve_iterations: int = 8
    solve_bucket_min: int = 128
    cov_every: int = 8
    cov_loop_window: int = 64
    cov_on_loop_only: bool = True
    warm_start_solves: bool = True
    scan_to_map_keyframes: int = 1
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the distributed solver."""

    axis: str = "dev"
    num_devices: Optional[int] = None
