"""Data layer: audio IO, chunking, the HDF5 store, MusicNet curation,
preprocessing, the in-memory chunk dataset with its native batch assembler,
and the device-resident store."""
from . import audio_io, chunking, dataset, hdf5_store  # noqa: F401
