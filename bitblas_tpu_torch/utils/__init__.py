"""Utilities: on-card timing (utils/timing.py)."""
