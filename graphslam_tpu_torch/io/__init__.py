"""Dataset IO: the g2o reader/writer (a native C++ parser with a numpy
fallback), synthetic generators, replay logs and checkpoints
(io/checkpoint.py)."""

from graphslam_tpu_torch.io.g2o import load_g2o, save_g2o  # noqa: F401
from graphslam_tpu_torch.io import datasets  # noqa: F401
