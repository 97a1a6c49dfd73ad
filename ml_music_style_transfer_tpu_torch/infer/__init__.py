"""Inference: reference checkpoint loading, tiled forward, Griffin-Lim."""
from . import synthesize  # noqa: F401
from .synthesize import AudioSynthesizer  # noqa: F401
