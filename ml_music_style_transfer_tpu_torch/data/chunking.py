"""Chunk index math: the reference's slicing contract, vectorized.

The port's own copy of the JAX package's ``data/chunking.py`` (NumPy):
  - samples per chunk (spc*wps - 1)*ws = 219,904 (preprocess.py:66)
  - audio chunk k starts at k*ws*stride (preprocess.py:67)
  - roll chunk k: windows [k*stride, k*stride + spc*wps) (preprocess.py:86-88)
  - num_chunks = (roll_len - 860)//512, minus a 10% safety offset, capped at
    max_chunks (preprocess.py:118-136); the ``max_chunks`` flag is wired
    through (the reference parsed -max-chunks-per-song but never used it).

Extraction returns stacked arrays, so the STFT runs batched.
"""
from __future__ import annotations

import numpy as np

from ..config import DSPConfig, DEFAULT_DSP


def num_song_chunks(
    roll_len: int,
    hp: DSPConfig = DEFAULT_DSP,
    offset_percentage: float = 0.1,
    max_chunks: int = 100,
) -> int:
    """Number of usable chunks in a song (preprocess.py:118-136)."""
    num_chunks = (roll_len - hp.windows_per_chunk) // hp.stride
    offset = int(offset_percentage * num_chunks)
    num_chunks -= offset
    return max(0, min(num_chunks, max_chunks))


def chunk_audio(
    audio: np.ndarray, num_chunks: int, hp: DSPConfig = DEFAULT_DSP
) -> np.ndarray:
    """Slice a waveform into (num_chunks, 219904) overlapping chunks."""
    n = hp.samples_per_chunk
    hop = hp.chunk_hop_samples
    need = (num_chunks - 1) * hop + n if num_chunks > 0 else 0
    if len(audio) < need:
        audio = np.pad(audio, (0, need - len(audio)))
    idx = np.arange(num_chunks)[:, None] * hop + np.arange(n)[None, :]
    return np.ascontiguousarray(audio[idx], dtype=np.float32)


def chunk_pianoroll(
    roll: np.ndarray, num_chunks: int, hp: DSPConfig = DEFAULT_DSP
) -> np.ndarray:
    """Slice a (T, 128) roll/onoff matrix into (num_chunks, 860, 128)."""
    n = hp.windows_per_chunk
    need = (num_chunks - 1) * hp.stride + n if num_chunks > 0 else 0
    if roll.shape[0] < need:
        roll = np.pad(roll, ((0, need - roll.shape[0]), (0, 0)))
    idx = np.arange(num_chunks)[:, None] * hp.stride + np.arange(n)[None, :]
    return np.ascontiguousarray(roll[idx], dtype=np.float32)
