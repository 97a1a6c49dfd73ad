"""WAV read/write + resampling (host side).

The port's own copy of ``read_wav``/``write_wav`` from the JAX package's
``data/audio_io.py``. Reading returns mono float32 in [-1, 1] resampled to
the target rate (librosa.load semantics, polyphase resampler); malformed
input raises ValueError, never a raw parser error.

Decoding is native by default: ``csrc/wavdec.cpp``, built by
``ops/kernels/_build.load_host`` (g++) at first use and called through
ctypes, which releases the GIL for the whole call, so the serving daemon's
reader thread decodes while its completer waits on the card. The scipy
path (``native=False``) is the parity anchor; both obey the same
malformed-input contract. Unlike the JAX package, which quietly falls back
to scipy when its library is missing, the native path raises when the
library cannot be built or loaded (the rule of ``data/fastloader.py``).
"""
from __future__ import annotations

import ctypes
import functools
import os
import warnings

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

_FP = ctypes.POINTER(ctypes.c_float)
# wd_decode's negative codes that name their fault (the rest are unreadable bytes)
_DECODE_ERRORS = {-4: "WAV contains no samples", -5: "WAV contains non-finite samples",
                  -6: "WAV declares non-positive sample rate"}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The decoder library, built at first use, with its C signatures bound."""
    from ..ops.kernels import _build

    lib = _build.load_host("wavdec")
    lib.wd_decode.restype = ctypes.c_longlong
    lib.wd_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FP), ctypes.POINTER(ctypes.c_int)]
    lib.wd_resample_poly.restype = ctypes.c_longlong
    lib.wd_resample_poly.argtypes = [_FP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(_FP)]
    lib.wd_free.restype = None
    lib.wd_free.argtypes = [_FP]
    return lib


def _take(lib, ptr, n: int) -> np.ndarray:
    """A numpy copy of the library's ``n`` floats at ``ptr``, which is freed."""
    try:
        return np.ctypeslib.as_array(ptr, shape=(int(n),)).copy()
    finally:
        lib.wd_free(ptr)


def _ratio(rate: int, sr: int, path: str) -> tuple[int, int]:
    g = np.gcd(int(sr), int(rate))
    up, down = int(sr) // g, int(rate) // g
    if max(up, down) > 65536:
        # resample_poly's FIR grows with max(up, down): refuse absurd rates
        raise ValueError(f"cannot resample {rate} Hz -> {sr} Hz (ratio {up}/{down} "
                         f"too extreme — corrupt sample rate?): {path}")
    return up, down


def resample_native(y: np.ndarray, up: int, down: int) -> np.ndarray:
    """``scipy.signal.resample_poly(y, up, down)`` (float64 inside, float32
    out) by the native library."""
    lib = _lib()
    x = np.ascontiguousarray(y, dtype=np.float32)
    out = _FP()
    m = lib.wd_resample_poly(x.ctypes.data_as(_FP), len(x), up, down, ctypes.byref(out))
    if m < 0:
        raise ValueError(f"cannot resample by {up}/{down} (code {m})")
    return _take(lib, out, m)


def _read_wav_native(path: str, sr: int | None) -> tuple[np.ndarray, int]:
    lib = _lib()
    out = _FP()
    rate_c = ctypes.c_int(0)
    n = lib.wd_decode(os.fsencode(path), ctypes.byref(out), ctypes.byref(rate_c))
    if n == -1:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if os.path.isdir(path):
            raise IsADirectoryError(path)
        raise ValueError(f"not a readable WAV file: {path}")
    if n < 0:
        raise ValueError(f"{_DECODE_ERRORS.get(n, 'not a readable WAV file')}: {path} "
                         f"(code {n})")
    y = _take(lib, out, n)
    rate = int(rate_c.value)
    if sr is not None and rate != sr:
        y = resample_native(y, *_ratio(rate, sr, path))
        rate = sr
    return y, rate


def _read_wav_scipy(path: str, sr: int | None) -> tuple[np.ndarray, int]:
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
        up, down = _ratio(rate, sr, path)
        y = resample_poly(y.astype(np.float64), up, down).astype(np.float32)
        rate = sr
    return np.ascontiguousarray(y, dtype=np.float32), rate


def read_wav(path: str, sr: int | None = 44100,
             native: bool | None = None) -> tuple[np.ndarray, int]:
    """Load a WAV as mono float32 in [-1, 1], resampled to ``sr`` if given.

    Malformed, truncated or degenerate input raises ValueError;
    FileNotFoundError stays FileNotFoundError. ``native``: None (the
    default) and True decode with the native library (its build or load
    failing raises), False with scipy (the parity anchor)."""
    if native is False:
        return _read_wav_scipy(path, sr)
    return _read_wav_native(path, sr)


def write_wav(path: str, y: np.ndarray, sr: int = 44100) -> None:
    """Write mono float array as 16-bit PCM WAV (sf.write equivalent)."""
    y = np.asarray(y, dtype=np.float32)
    y = np.clip(y, -1.0, 1.0)
    wavfile.write(path, sr, (y * 32767.0).astype(np.int16))
