"""End-to-end metrics, one reader a metric: `read(run) -> float | None`."""
