"""Data substrate: the deterministic token pipeline (``pipeline``) and the
sparse matrix generators (``matrices``), numpy/scipy, no device state."""

from .pipeline import TokenPipeline

__all__ = ["TokenPipeline"]
