"""Data substrate: the deterministic synthetic token pipeline."""

from .pipeline import DataConfig, SyntheticPipeline, make_batch  # noqa: F401
