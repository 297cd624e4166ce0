"""Metric accumulation for evaluation (single process; the collectives
come with data-parallel training)."""
from .collect import MetricAccumulator  # noqa: F401
