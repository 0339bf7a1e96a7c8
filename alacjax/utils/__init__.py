"""Utilities: structured metrics, logging, profiling annotations.

The reference has no observability at all (SURVEY.md §5); this package
provides jax.profiler stage annotations, per-run structured reports, a
dependency-free logger, and the compile-cache placement.
"""

from .metrics import StreamReport, StageTimer, stage_annotation
from .log import get_logger

__all__ = ["StreamReport", "StageTimer", "stage_annotation", "get_logger"]
