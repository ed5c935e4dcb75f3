"""Multi-rank scaling of the pose-graph optimizer on torch.distributed.

Port of graphslam_tpu/parallel/. The JAX package's `jax.sharding.Mesh` over
all chips becomes a process group with one process per rank
(parallel/dist.py::Mesh): factors sharded across ranks, poses replicated,
and each `psum` of the JAX code one all-reduce (NCCL between GPUs, gloo
between CPU processes). The fused families run SE(2) (dist_fused) and SE(3)
(dist_fused6) graphs; the Schur solver (dist_schur) is not ported yet.
"""

from graphslam_tpu_torch.parallel.dist import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_graph,
    dist_gn_solve,
    dist_lm_solve,
)
from graphslam_tpu_torch.parallel.dist_fused import (  # noqa: F401
    dist_fused_gn_solve,
    dist_fused_lm_solve,
)
from graphslam_tpu_torch.parallel.dist_fused6 import (  # noqa: F401
    dist_fused6_gn_solve,
    dist_fused6_lm_solve,
)
