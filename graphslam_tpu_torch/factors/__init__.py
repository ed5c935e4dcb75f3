"""Factor-graph data layer: struct-of-arrays tensors + batched linearization."""

from graphslam_tpu_torch.factors.graph import (  # noqa: F401
    FactorGraph,
    from_dataset,
    from_numpy,
)
from graphslam_tpu_torch.factors.linearize import (  # noqa: F401
    linearize,
    residuals,
    chi2,
)
