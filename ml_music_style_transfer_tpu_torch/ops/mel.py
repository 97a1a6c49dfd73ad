"""Mel-scale ops in PyTorch (the JAX package's ``ops/mel.py:19-51``).

The filterbank is a constant built once on the host (NumPy, float64, then
float32) and uploaded once per device, so a training step's spectral loss
copies nothing to the card; applying it is one (mels x bins) matmul. MFCCs
wait for a later slice.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import reference as npref


@functools.lru_cache(maxsize=None)
def _mel_fb_const(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None) -> np.ndarray:
    return npref.mel_filterbank(sr, n_fft, n_mels, fmin, fmax).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mel_fb_device(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mel_fb_const(sr, n_fft, n_mels, fmin, fmax)).to(device)


def mel_filterbank(sr: int = 44100, n_fft: int = 2048, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None,
                   device="cpu") -> torch.Tensor:
    """Slaney-normalized mel filterbank, (n_mels, 1 + n_fft//2) float32.
    The tensor is shared between calls: do not modify it in place."""
    return _mel_fb_device(sr, n_fft, n_mels, fmin, fmax, torch.device(device))


def melspectrogram_from_power(power_spec: torch.Tensor, sr: int = 44100, n_fft: int = 2048,
                              n_mels: int = 128, fmin: float = 0.0,
                              fmax: float | None = None) -> torch.Tensor:
    """(..., bins, frames) power spectrogram -> (..., n_mels, frames), in
    the promoted dtype of the input and the float32 bank (librosa's
    melspectrogram given |STFT|^2)."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, power_spec.device)
    dt = torch.promote_types(power_spec.dtype, torch.float32)
    return torch.matmul(fb.to(dt), power_spec.to(dt))
