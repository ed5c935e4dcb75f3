"""Online incremental SLAM pipeline (port of graphslam_tpu/slam): one step
function over a preallocated SLAMState covers the keyframe decision, the
loop candidate search, factor commits and the periodic bucketed solve; the
odometry buffer (slam/odometry.py) feeds the twist-driven replay."""

from graphslam_tpu_torch.slam.state import SLAMState, init_state  # noqa: F401
from graphslam_tpu_torch.slam.pipeline import make_slam_step, run_slam, StepInfo  # noqa: F401
from graphslam_tpu_torch.slam.odometry import OdometryBuffer, integrate_twist  # noqa: F401
