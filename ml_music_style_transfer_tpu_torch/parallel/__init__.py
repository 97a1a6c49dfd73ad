"""Time-axis helpers for the whole-clip path (single device)."""
from . import time_shard  # noqa: F401
