"""Deterministic synthetic data pipeline (checkpointable)."""
from .pipeline import TokenPipeline  # noqa: F401
