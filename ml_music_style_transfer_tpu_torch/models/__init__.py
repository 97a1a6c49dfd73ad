"""Model family of this slice: PerformanceNet (the autoencoder comes later)."""
from . import layers, performance_net  # noqa: F401
from .performance_net import PerformanceNet, forward_channel_first, temporal_ladder  # noqa: F401
