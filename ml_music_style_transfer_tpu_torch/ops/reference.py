"""NumPy golden implementations of the DSP ops (librosa-compatible
semantics): the port's own copy of the JAX package's ``ops/reference.py``.

The window, NOLA and mel helpers give the port's DSP constants; ``stft``,
``istft``, ``log_power``, ``inverse_log_power`` and ``griffinlim`` are the
host STFT backend of preprocessing and the float64 anchor that the torch
ops and the quality gate are held against.

Conventions (librosa of the reference's era): the hann window is periodic,
win_length == n_fft by default, center=True reflect-pads by n_fft//2, and
STFT output is (1 + n_fft//2, 1 + len(y)//hop).
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


def frame(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into overlapping windows, shape (n_frames, frame_length)."""
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = (
        np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    )
    return y[idx]


def stft(
    y: np.ndarray,
    n_fft: int = 2048,
    hop_length: int = 256,
    win_length: int | None = None,
    center: bool = True,
    pad_mode: str = "reflect",
) -> np.ndarray:
    """Complex STFT, (1 + n_fft//2, n_frames), librosa.stft semantics."""
    if win_length is None:
        win_length = n_fft
    window = pad_center(hann_window(win_length), n_fft)
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    frames = frame(y, n_fft, hop_length) * window[None, :]
    return np.fft.rfft(frames, axis=-1).T


def istft(
    S: np.ndarray,
    hop_length: int = 256,
    win_length: int | None = None,
    center: bool = True,
    length: int | None = None,
) -> np.ndarray:
    """Inverse STFT with NOLA normalization (librosa.istft semantics)."""
    n_fft = 2 * (S.shape[0] - 1)
    if win_length is None:
        win_length = n_fft
    window = pad_center(hann_window(win_length), n_fft)
    frames = np.fft.irfft(S.T, n=n_fft, axis=-1) * window[None, :]
    n_frames = frames.shape[0]
    out_len = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(out_len, dtype=np.float64)
    for i in range(n_frames):
        s = i * hop_length
        y[s : s + n_fft] += frames[i]
    wss = window_sumsquare(window, n_frames, hop_length, n_fft)
    nz = wss > TINY
    y[nz] /= wss[nz]
    if center:
        y = y[n_fft // 2 : out_len - n_fft // 2]
    if length is not None:
        y = np.pad(y[:length], (0, max(0, length - len(y))))
    return y


def log_power(S: np.ndarray) -> np.ndarray:
    """Log-power compression log1p(|S|^2) (reference preprocess.py:49)."""
    return np.log1p(np.abs(S) ** 2)


def inverse_log_power(spec: np.ndarray, clip_max: float = 20.0) -> np.ndarray:
    """Exact inverse sqrt(expm1(clip(spec, 0, clip_max))) (reference inference.py:109)."""
    return np.sqrt(np.expm1(np.clip(spec, 0.0, clip_max)))


def griffinlim(
    magnitude: np.ndarray,
    n_iter: int = 300,
    hop_length: int = 256,
    win_length: int | None = None,
    momentum: float = 0.99,
    length: int | None = None,
    init_phase: np.ndarray | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Griffin-Lim phase recovery with momentum (librosa.griffinlim algorithm).

    Reference call: model/inference.py:110 (n_iter=300, hann, win_length=2048,
    hop_length=256). ``init_phase`` (radians, same shape as ``magnitude``)
    allows bit-identical comparison against the JAX implementation.
    """
    n_fft = 2 * (magnitude.shape[0] - 1)
    if win_length is None:
        win_length = n_fft
    rng = np.random.default_rng(seed)
    if init_phase is None:
        init_phase = 2.0 * np.pi * rng.random(magnitude.shape)
    angles = np.exp(1j * init_phase)
    rebuilt = np.zeros_like(angles)
    eps = TINY
    for _ in range(n_iter):
        tprev = rebuilt
        inverse = istft(magnitude * angles, hop_length, win_length, length=length)
        rebuilt = stft(inverse, n_fft, hop_length, win_length)
        angles = rebuilt - (momentum / (1.0 + momentum)) * tprev
        angles /= np.abs(angles) + eps
    return istft(magnitude * angles, hop_length, win_length, length=length)


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
