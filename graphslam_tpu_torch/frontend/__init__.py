"""Laser-scan frontend: projection and GICP-class scan matching (port of
graphslam_tpu/frontend). Fixed-shape and masked throughout."""

from graphslam_tpu_torch.frontend.projection import scan_to_points  # noqa: F401
from graphslam_tpu_torch.frontend.icp import (  # noqa: F401
    estimate_normals,
    gicp_match,
    MatchResult,
)
from graphslam_tpu_torch.frontend.keyframes import motion_covariance  # noqa: F401
