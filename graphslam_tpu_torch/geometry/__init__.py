"""Batched Lie-group geometry on torch tensors: SO(2), SE(2), SO(3), SE(3)."""

from graphslam_tpu_torch.geometry import se2, se3, so2, so3  # noqa: F401
