"""WAV read/write + resampling (host side), on the scipy path.

The port's own copy of ``read_wav``/``write_wav`` from the JAX package's
``data/audio_io.py``, without the native decoder. Reading returns mono
float32 in [-1, 1] resampled to the target rate (librosa.load semantics,
polyphase resampler); malformed input raises ValueError.
"""
from __future__ import annotations

import warnings

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str, sr: int | None = 44100) -> tuple[np.ndarray, int]:
    """Load a WAV as mono float32 in [-1, 1], resampled to ``sr`` if given."""
    try:
        with warnings.catch_warnings():
            # scipy warns per odd/unknown RIFF chunk on files it still reads
            warnings.simplefilter("ignore")
            rate, data = wavfile.read(path)
    except (FileNotFoundError, IsADirectoryError):
        raise
    except Exception as e:  # scipy leaks ValueError/struct.error/EOFError
        raise ValueError(f"not a readable WAV file: {path}: {e}") from e
    if int(rate) <= 0:
        raise ValueError(f"WAV declares non-positive sample rate {rate}: {path}")
    if data.size == 0:
        raise ValueError(f"WAV contains no samples: {path}")
    if data.dtype.kind == "f" and not np.isfinite(data).all():
        raise ValueError(f"WAV contains non-finite samples: {path}")
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64 wavs
        y = data.astype(np.float32)
    if y.ndim == 2:
        y = y.mean(axis=1)
    if sr is not None and rate != sr:
        g = np.gcd(int(sr), int(rate))
        up, down = int(sr) // g, int(rate) // g
        if max(up, down) > 65536:
            # resample_poly's FIR grows with max(up, down): refuse absurd rates
            raise ValueError(
                f"cannot resample {rate} Hz -> {sr} Hz (ratio {up}/{down} "
                f"too extreme — corrupt sample rate?): {path}")
        y = resample_poly(y.astype(np.float64), up, down).astype(np.float32)
        rate = sr
    return np.ascontiguousarray(y, dtype=np.float32), rate


def write_wav(path: str, y: np.ndarray, sr: int = 44100) -> None:
    """Write mono float array as 16-bit PCM WAV (sf.write equivalent)."""
    y = np.asarray(y, dtype=np.float32)
    y = np.clip(y, -1.0, 1.0)
    wavfile.write(path, sr, (y * 32767.0).astype(np.int16))
