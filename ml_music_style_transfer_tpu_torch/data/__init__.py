"""Data layer: audio IO (the rest of the data path arrives in a later slice)."""
from . import audio_io  # noqa: F401
