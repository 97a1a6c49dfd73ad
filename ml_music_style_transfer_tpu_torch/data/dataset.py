"""In-memory chunk dataset and host-side batch assembly (the JAX package's
``data/dataset.py:26-139``; reference model/train.py:45-116).

  - the whole split lives in RAM, float32 and time-major (T, C), so batch
    assembly is row gathers with no per-item transposes;
  - per item a random style and a random conditioning index (train.py:88-91,
    "timbre from audio, content from MIDI") come from a seeded NumPy RNG;
  - batches are whole NumPy arrays, channel-last: midi/onoff (B, 860, 128),
    cond/target (B, 860, 1025), plus a per-item ``weight`` (B,) mask.

``ChunkDataset(path)`` reads an HDF5 split (needs h5py);
``ChunkDataset.from_arrays(raw, seed)`` builds from the dict that
``load_dataset`` (or ``preprocess.get_arrays``) returns, for callers that
hold the arrays already. ``native_assembler`` gives the split's C++ batch
assembler (``data/fastloader.py``), which draws in its own order.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from .hdf5_store import load_dataset


class ChunkDataset:
    """All chunks of one split in RAM; samples batches with style pairing."""

    def __init__(self, path: str, n_read: int | None = None, seed: int = 42):
        raw = load_dataset(path, n_read=n_read, include_audio=False)
        self._init_arrays(raw, seed, path)

    @classmethod
    def from_arrays(cls, raw: Dict[str, np.ndarray], seed: int = 42,
                    source: str = "<arrays>") -> "ChunkDataset":
        """A dataset over ``raw`` = {'pianoroll': (N,860,128), 'onoff':
        (N,860,128), 'spec_<style>': (N,1025,860), ...}."""
        obj = cls.__new__(cls)
        obj._init_arrays(raw, seed, source)
        return obj

    def _init_arrays(self, raw: Dict[str, np.ndarray], seed: int, source: str) -> None:
        self.styles: List[str] = sorted(k for k in raw if k.startswith("spec_"))
        if not self.styles:
            raise ValueError(f"no spec_* keys in {source}")
        # time-major copies: rolls already (N, 860, 128); specs stored
        # (N, 1025, 860) -> keep (N, 860, 1025) so assembly is a row gather
        self.pianoroll = np.ascontiguousarray(raw["pianoroll"], dtype=np.float32)
        self.onoff = np.ascontiguousarray(raw["onoff"], dtype=np.float32)
        self.specs = {
            s: np.ascontiguousarray(raw[s].transpose(0, 2, 1), dtype=np.float32)
            for s in self.styles
        }
        self.n_data = self.pianoroll.shape[0]
        # alignment guard: a style missing for SOME songs leaves its spec_*
        # dataset shorter than the roll, and indices would silently point at
        # the wrong music (io_manager.py:41 contract vs preprocess.py:185-190)
        bad = {s: raw[s].shape[0] for s in self.styles if raw[s].shape[0] != self.n_data}
        if bad:
            raise ValueError(
                f"misaligned dataset {source}: pianoroll has {self.n_data} chunks "
                f"but styles {bad} differ — some songs lack those styles' audio; "
                "preprocess with a style set present for every song"
            )
        self.rng = np.random.default_rng(seed)
        self._native: dict = {}

    def native_assembler(self, batch_size: int, pin_memory: bool = False):
        """The split's native (C++) slot-ring batch assembler for
        ``batch_size``, cached; ``pin_memory`` page-locks its slots for
        non-blocking copies to the card. Raises if the library cannot be
        built or loaded; there is no Python fallback here."""
        key = (batch_size, pin_memory)
        if key not in self._native:
            from .fastloader import NativeBatchAssembler

            self._native[key] = NativeBatchAssembler(self, batch_size, pin_memory=pin_memory)
        return self._native[key]

    def assemble(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """One batch for chunk indices ``idx`` (train.py:76-101): per item a
        random style; target = that style's spec at idx; cond = the same
        style's spec at a random other index."""
        b = len(idx)
        style_ids = self.rng.integers(0, len(self.styles), b)
        cond_idx = self.rng.integers(0, self.n_data, b)
        t_bins = self.specs[self.styles[0]].shape[1:]
        cond = np.empty((b,) + t_bins, dtype=np.float32)
        target = np.empty((b,) + t_bins, dtype=np.float32)
        for j in range(b):
            spec = self.specs[self.styles[style_ids[j]]]
            target[j] = spec[idx[j]]
            cond[j] = spec[cond_idx[j]]
        return {
            "midi": self.pianoroll[idx],
            "onoff": self.onoff[idx],
            "cond": cond,
            "target": target,
        }

    def epoch_batches(
        self, batch_size: int, shuffle: bool = True, drop_last: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of batches (DataLoader equivalent, train.py:114).

        With drop_last=False the final partial batch is padded to
        batch_size and its 'weight' mask (per item 1/0) keeps masked losses
        exact.
        """
        order = self.rng.permutation(self.n_data) if shuffle else np.arange(self.n_data)
        for s in range(0, self.n_data, batch_size):
            idx = order[s : s + batch_size]
            weight = np.ones(batch_size, np.float32)
            if len(idx) < batch_size:
                if drop_last:
                    return
                weight[len(idx):] = 0.0
                idx = np.concatenate([idx, np.zeros(batch_size - len(idx), dtype=idx.dtype)])
            batch = self.assemble(idx)
            batch["weight"] = weight
            yield batch

    def batches_per_epoch(self, batch_size: int, drop_last: bool = True) -> int:
        if drop_last:
            return self.n_data // batch_size
        return -(-self.n_data // batch_size)


def process_data(
    data_dir: str,
    n_train_read: int | None = None,
    n_test_read: int | None = None,
    seed: int = 42,
) -> tuple["ChunkDataset", "ChunkDataset"]:
    """Load the train/test splits (reference Process_Data, train.py:107-116)."""
    train = ChunkDataset(data_dir + "_train.hdf5", n_read=n_train_read, seed=seed)
    test = ChunkDataset(data_dir + "_test.hdf5", n_read=n_test_read, seed=seed + 1)
    return train, test
