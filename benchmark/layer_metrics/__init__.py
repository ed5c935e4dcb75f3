"""Per-layer metrics, one reader a metric: `read(run) -> float | None`.
A reader that finds nothing to read returns None and the metric is left out."""
