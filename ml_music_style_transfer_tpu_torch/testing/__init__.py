"""Synthetic inputs for the serving daemon's warm-up, demos and tests."""
from . import synthetic  # noqa: F401
