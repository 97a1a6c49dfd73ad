"""The preprocessed dataset store: the JAX package's ``data/hdf5_store.py``
(``H5Store`` :15-47, ``load_dataset`` :50-76), plus ``ArrayStore``.

Schema (reference preprocessing/utils/io_manager.py:39-77): ``pianoroll``
(N, 860, 128), ``onoff`` (N, 860, 128), ``spec_{style}`` (N, 1025, 860)
and, for device-resident training, ``audio_{style}`` (N, 219904), aligned
so index i is the same musical chunk in every key. Each key is a resizable
chunked dataset (``maxshape=(None, ...)``, ``chunks=True``) of ``dtype``
(float32 by default; the reference stored float64), the same as the JAX
package writes, so a file written by either package loads in the other.

``h5py`` is imported only where a file is opened, so the package imports
where h5py is missing. ``ArrayStore`` is the same writer into host memory:
it holds what ``load_dataset`` would read back from the file, for callers
that train from arrays (``ChunkDataset.from_arrays``,
``DeviceDataStore.from_arrays``) on a machine without h5py.
"""
from __future__ import annotations

import numpy as np


class H5Store:
    """Create and append resizable datasets in an open ``h5py.File``
    (the reference's h5pyManager)."""

    def __init__(self, h5file, dtype: str = "float32"):
        self.data = h5file
        self.dtype = dtype

    def _append(self, key: str, arr: np.ndarray) -> None:
        if key not in self.data:
            self.data.create_dataset(
                key,
                data=arr.astype(self.dtype),
                dtype=self.dtype,
                maxshape=(None,) + arr.shape[1:],
                chunks=True,
            )
        else:
            ds = self.data[key]
            ds.resize(ds.shape[0] + arr.shape[0], axis=0)
            ds[-arr.shape[0]:] = arr.astype(self.dtype)

    def write_pianoroll(self, pianoroll_list: np.ndarray, onoff_list: np.ndarray) -> None:
        """Append aligned roll + onoff chunks (io_manager.py:46-62)."""
        self._append("pianoroll", pianoroll_list)
        self._append("onoff", onoff_list)

    def write_spectrum(self, spec_list: np.ndarray, style: str) -> None:
        """Append spectrogram chunks for one style (io_manager.py:64-76)."""
        self._append(f"spec_{style}", spec_list)

    def write_audio(self, audio_chunks: np.ndarray, style: str) -> None:
        """Append raw audio chunks for one style (device-resident training)."""
        self._append(f"audio_{style}", audio_chunks)


class ArrayStore(H5Store):
    """``H5Store``'s writes kept in host memory; ``arrays()`` returns what
    ``load_dataset`` returns for the file ``H5Store`` would have written."""

    def __init__(self, dtype: str = "float32"):
        super().__init__(None, dtype)
        self._parts: dict[str, list[np.ndarray]] = {}

    def _append(self, key: str, arr: np.ndarray) -> None:
        self._parts.setdefault(key, []).append(np.asarray(arr, dtype=self.dtype))

    def arrays(self) -> dict[str, np.ndarray]:
        return {k: np.concatenate(v) for k, v in sorted(self._parts.items())}


def load_dataset(
    path: str,
    n_read: int | None = None,
    dtype: str = "float32",
    include_audio: bool = True,
    include_specs: bool = True,
) -> dict[str, np.ndarray]:
    """Read a preprocessed HDF5 file fully into RAM (train.py:58-71 strategy).

    Returns {'pianoroll': (N,860,128), 'onoff': ..., 'spec_<style>': ...,
    optionally 'audio_<style>': ...}, each as ``dtype``; styles are
    discovered from the key names (train.py:51). ``include_audio=False``
    skips the raw-audio keys (only the device-resident path needs them);
    ``include_specs=False`` skips the spectrograms (the device-resident path
    recomputes them on the device).
    """
    import h5py

    prefixes = tuple(
        p for p, on in (("spec_", include_specs), ("audio_", include_audio)) if on
    )
    out: dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        for key in f.keys():
            if key in ("pianoroll", "onoff") or key.startswith(prefixes):
                ds = f[key]
                out[key] = np.asarray(ds[:n_read] if n_read is not None else ds[:], dtype=dtype)
    return out
