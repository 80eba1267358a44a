"""Utilities: on-card timing (utils/timing.py) and profiling
(utils/profiling.py)."""
