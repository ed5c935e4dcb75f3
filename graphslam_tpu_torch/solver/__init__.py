"""Pose-graph optimizer: Gauss-Newton over the linearized factor blocks."""

from graphslam_tpu_torch.solver.lm import gn_solve  # noqa: F401
from graphslam_tpu_torch.solver.normal_eq import (  # noqa: F401
    build_blocks,
    dense_solve,
    pcg_solve,
    BlockSystem,
)
from graphslam_tpu_torch.solver.tridiag import cr_factor, cr_solve  # noqa: F401
