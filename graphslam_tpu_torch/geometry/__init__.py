"""Batched Lie-group geometry on torch tensors (SO(2), SE(2)).

SO(3)/SE(3) wait for the SE(3) slice (ROADMAP.md, module queue).
"""

from graphslam_tpu_torch.geometry import se2, so2  # noqa: F401
