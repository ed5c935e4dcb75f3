"""graphslam_tpu_torch — the PyTorch/CUDA port of graphslam_tpu.

The JAX package (`graphslam_tpu/`) is the reference; this package mirrors
its module paths and public names so each counterpart is found at once:

  config.py            SolverConfig and the other dataclasses, same defaults
  io/                  g2o reader (native C++ parser, numpy fallback),
                       synthetic generators, replay logs, checkpoints
  geometry/            batched SO(2)/SE(2) and SO(3)/SE(3) ops on torch tensors
  factors/             FactorGraph dataclass of tensors, SE(2) and SE(3)
                       linearization
  solver/              normal equations, cyclic reduction, GN and LM
                       loops, chordal init, the partitioned Schur solve,
                       marginals (dense, per-pose CG, all-pose)
  sim/                 segment-world raycaster, occupancy grids and
                       scripted tours
  frontend/            scan projection, keyframe gates, GICP matching
  slam/                the online pipeline's state, step and replays, and
                       the odometry buffer of the twist-driven replay
  ops/                 hand-written CUDA kernels with their plain twins
  parallel/            the distributed solvers on torch.distributed, with
                       the kernels of a distributed GN iteration, and the
                       rank-sharded Schur GN
  metrics.py, utils.py ATE/RPE, timers and counters, device sync, card
                       info, profiler trace
  viz.py               trajectory and map figures (matplotlib, or PIL
                       where matplotlib is missing)
  dryrun.py            the dry-run entry points: one GN step, and every
                       distributed solver over a process group

As in the JAX package, `geometry` is imported with the package and
`from_dataset`, `lm_solve`, `gn_solve`, `run_slam`, `load` and `ate` are
served lazily at the top level.

It imports torch and never jax. All math is float32; TF32 is switched off
for matmuls and cuDNN at import, because it keeps only ~3 decimal digits
(the Hopper twin of the TPU's bf16 matmul hazard).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from graphslam_tpu_torch import geometry  # noqa: E402,F401
from graphslam_tpu_torch.config import (  # noqa: E402,F401
    FrontendConfig,
    MeshConfig,
    SLAMConfig,
    SolverConfig,
)


def __getattr__(name):
    """Lazy top-level conveniences (keep bare import light)."""
    import importlib

    lazy = {
        "from_dataset": ("graphslam_tpu_torch.factors", "from_dataset"),
        "lm_solve": ("graphslam_tpu_torch.solver", "lm_solve"),
        "gn_solve": ("graphslam_tpu_torch.solver", "gn_solve"),
        "run_slam": ("graphslam_tpu_torch.slam", "run_slam"),
        "load": ("graphslam_tpu_torch.io.datasets", "load"),
        "ate": ("graphslam_tpu_torch.metrics", "ate"),
    }
    if name in lazy:
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'graphslam_tpu_torch' has no attribute {name!r}")
