"""Data layer: audio IO, the HDF5 reader and the in-memory chunk dataset
(preprocessing, the native loader and the device store arrive later)."""
from . import audio_io, dataset, hdf5_store  # noqa: F401
