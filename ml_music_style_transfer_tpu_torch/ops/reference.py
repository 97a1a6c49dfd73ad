"""NumPy helpers for the DSP constants (window and NOLA normalisation).

The port's own copy of the helpers it needs from the JAX package's
``ops/reference.py`` (librosa-compatible semantics).
"""
from __future__ import annotations

import numpy as np

TINY = 1.1754944e-38  # float32 tiny, librosa.util.tiny equivalent


def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann', n, fftbins=True))."""
    n = np.arange(win_length, dtype=dtype)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` (librosa.util.pad_center)."""
    lpad = (size - len(window)) // 2
    rpad = size - len(window) - lpad
    return np.pad(window, (lpad, rpad))


def window_sumsquare(
    window: np.ndarray, n_frames: int, hop_length: int, n_fft: int
) -> np.ndarray:
    """Sum of squared, hop-shifted windows (librosa.filters.window_sumsquare)."""
    length = n_fft + hop_length * (n_frames - 1)
    x = np.zeros(length, dtype=np.float64)
    wsq = window.astype(np.float64) ** 2
    for i in range(n_frames):
        s = i * hop_length
        x[s : s + n_fft] += wsq
    return x
