"""NumPy helpers for the DSP constants (window, NOLA normalisation, mel
filterbank).

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


def hz_to_mel(frequencies: np.ndarray, htk: bool = False) -> np.ndarray:
    """Slaney (default) or HTK mel scale (librosa.hz_to_mel)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = frequencies >= min_log_hz
    mels = np.where(
        log_t,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray, htk: bool = False) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(
    sr: int = 44100,
    n_fft: int = 2048,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, 1 + n_fft//2)
    (librosa.filters.mel(norm='slaney', htk=False))."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(np.array(fmin), htk), hz_to_mel(np.array(fmax), htk), n_mels + 2),
        htk,
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return weights * enorm[:, None]
