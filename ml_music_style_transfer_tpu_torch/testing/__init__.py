"""Synthetic inputs (songs, renderings, dataset directories) and the quality
gate's style-discrimination measure."""
from . import quality, synthetic  # noqa: F401
