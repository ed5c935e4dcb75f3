"""Dataset IO: numpy-only g2o reader/writer and synthetic generators."""

from graphslam_tpu_torch.io.g2o import load_g2o, save_g2o  # noqa: F401
from graphslam_tpu_torch.io import datasets  # noqa: F401
