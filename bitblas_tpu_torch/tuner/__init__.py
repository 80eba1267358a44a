"""Tuning hints (counterpart of bitblas_tpu/tuner); the port has no
measured tuner yet, only the hint that pins a Matmul route."""

from .hint import TileHint

__all__ = ["TileHint"]
