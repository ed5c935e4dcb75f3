"""Online incremental SLAM pipeline (port of graphslam_tpu/slam): one step
function over a preallocated SLAMState covers the keyframe decision, the
loop candidate search, factor commits and the periodic bucketed solve. The
odometry buffer (slam/odometry.py) is not ported yet."""

from graphslam_tpu_torch.slam.state import SLAMState, init_state  # noqa: F401
from graphslam_tpu_torch.slam.pipeline import make_slam_step, run_slam, StepInfo  # noqa: F401
