"""graphslam_tpu_torch — the PyTorch/CUDA port of graphslam_tpu.

The JAX package (`graphslam_tpu/`) is the reference; this package mirrors
its module paths and public names so each counterpart is found at once:

  config.py            SolverConfig and the other dataclasses, same defaults
  io/                  numpy-only g2o reader and synthetic generators
  geometry/            batched SO(2)/SE(2) ops on torch tensors
  factors/             FactorGraph dataclass of tensors, SE(2) linearization
  solver/              normal equations, cyclic reduction, GN and LM
                       loops, chordal init, dense marginals
  sim/                 segment-world raycaster and scripted tours
  frontend/            scan projection, keyframe gates, GICP matching
  slam/                the online pipeline's state, step and replays
  ops/                 hand-written CUDA kernels with their plain twins
  parallel/            the distributed solvers on torch.distributed, with
                       the kernels of a distributed GN iteration
  metrics.py, utils.py ATE/RPE, device sync and card info

It imports torch and never jax. All math is float32; TF32 is switched off
for matmuls and cuDNN at import, because it keeps only ~3 decimal digits
(the Hopper twin of the TPU's bf16 matmul hazard).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from graphslam_tpu_torch.config import (  # noqa: E402,F401
    FrontendConfig,
    MeshConfig,
    SLAMConfig,
    SolverConfig,
)
