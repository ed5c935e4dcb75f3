"""Pose-graph optimizer: Gauss-Newton / Levenberg-Marquardt over the
linearized factor blocks, and chordal initialization."""

from graphslam_tpu_torch.solver.init import chordal_init_se2, chordal_init_se3  # noqa: F401
from graphslam_tpu_torch.solver.lm import LMState, gn_solve, lm_solve  # noqa: F401
from graphslam_tpu_torch.solver.normal_eq import (  # noqa: F401
    build_blocks,
    dense_solve,
    pcg_solve,
    BlockSystem,
)
from graphslam_tpu_torch.solver.schur import schur_plan, schur_solve  # noqa: F401
from graphslam_tpu_torch.solver.marginals import (  # noqa: F401
    marginal_covariances_dense,
    marginal_covariance_cg,
)
from graphslam_tpu_torch.solver.tridiag import cr_factor, cr_solve  # noqa: F401
