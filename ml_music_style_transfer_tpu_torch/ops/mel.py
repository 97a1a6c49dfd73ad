"""Mel-scale ops in PyTorch (the JAX package's ``ops/mel.py``).

The filterbank and the DCT-II matrix are constants built once on the host
(NumPy, float64, then float32) and uploaded once per device, so a training
step's spectral loss copies nothing to the card; applying either is one
matmul. ``log_mel_frames`` is the log-magnitude mel feature of Spectrogram
Diffusion (16 kHz, hop 320: 50 frames a second, 128 bands from 20 Hz).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import reference as npref
from . import stft as tstft


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


def log_mel_frames(audio: torch.Tensor, sr: int = 16000, n_fft: int = 2048, hop: int = 320,
                   n_mels: int = 128, fmin: float = 20.0, fmax: float | None = None,
                   floor: float = 1e-5) -> torch.Tensor:
    """(..., samples) float32 audio -> (..., frames, n_mels) float32
    ``log(max(mel(|STFT|), floor))``: the centred (reflect) STFT of
    ``ops/stft.py``, its magnitude, the Slaney mel bank, the natural log.
    81,600 samples give 256 frames at hop 320."""
    mag = tstft.stft(audio.float(), n_fft=n_fft, hop_length=hop).abs()
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, audio.device)
    return torch.log(torch.clamp(torch.matmul(mag.transpose(-1, -2), fb.t()), min=floor))


@functools.lru_cache(maxsize=None)
def _dct_const(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in), scipy.fft.dct(norm='ortho')."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_device(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dct_const(n_out, n_in)).to(device)


def mfcc_from_power(power_spec: torch.Tensor, sr: int = 44100, n_fft: int = 2048,
                    n_mfcc: int = 20, n_mels: int = 128) -> torch.Tensor:
    """(..., bins, frames) power spectrogram -> (..., n_mfcc, frames) MFCCs
    (librosa.feature.mfcc: the dB mel spectrogram, floored 80 dB below its
    peak, then the orthonormal DCT-II over the mel axis; JAX
    ``mel.py:64-81``)."""
    mel = melspectrogram_from_power(power_spec, sr, n_fft, n_mels)
    log_mel = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    log_mel = torch.maximum(log_mel, torch.amax(log_mel, dim=(-2, -1), keepdim=True) - 80.0)
    dct = _dct_device(n_mfcc, n_mels, power_spec.device).to(log_mel.dtype)
    return torch.matmul(dct, log_mel)
