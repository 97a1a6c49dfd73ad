"""Reading the preprocessed HDF5 dataset (the JAX package's
``data/hdf5_store.py:50-76``, ``load_dataset`` only).

Schema (reference preprocessing/utils/io_manager.py:39-77): ``pianoroll``
(N, 860, 128), ``onoff`` (N, 860, 128), ``spec_{style}`` (N, 1025, 860),
aligned so index i is the same musical chunk in every key. ``h5py`` is
imported inside ``load_dataset``, so the package imports where h5py is
missing; training from in-memory arrays (``ChunkDataset.from_arrays``)
needs none. Writing (``H5Store``) waits with the preprocessing port
(ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import numpy as np


def load_dataset(path: str, n_read: int | None = None,
                 include_audio: bool = True) -> dict[str, np.ndarray]:
    """Read a preprocessed HDF5 file fully into RAM, float32 (train.py:58-71
    strategy).

    Returns {'pianoroll': (N,860,128), 'onoff': ..., 'spec_<style>': ...,
    optionally 'audio_<style>': ...}; styles are discovered from keys
    matching ``spec_*`` (train.py:51).
    """
    import h5py

    prefixes = ("spec_", "audio_") if include_audio else ("spec_",)
    out: dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        for key in f.keys():
            if key in ("pianoroll", "onoff") or key.startswith(prefixes):
                ds = f[key]
                out[key] = np.asarray(ds[:n_read] if n_read is not None else ds[:],
                                      dtype=np.float32)
    return out
