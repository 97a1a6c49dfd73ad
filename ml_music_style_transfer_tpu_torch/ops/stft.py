"""STFT / iSTFT and log-power compression in PyTorch.

Counterpart of the JAX package's ``ops/stft.py`` (librosa semantics,
reference preprocessing/preprocess.py:47-57 and model/inference.py:105-110).
Framing keeps the dense reshape-shift decomposition and the overlap-add its
dense shifted sum (both need ``n_fft % hop == 0``, true for 2048/256). The
transforms are ``torch.fft.rfft``/``irfft`` (cuFFT on the card); the JAX
package's matmul-DFT transform is a TPU choice and is not ported.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import reference as npref


@functools.lru_cache(maxsize=None)
def window_const(n_fft: int, win_length: int) -> np.ndarray:
    """The periodic Hann window centre-padded to ``n_fft``, float32."""
    return npref.pad_center(npref.hann_window(win_length), n_fft).astype(np.float32)


@functools.lru_cache(maxsize=None)
def wss_inv_const(n_fft: int, win_length: int, hop: int, n_frames: int) -> np.ndarray:
    """1 / window_sumsquare where > tiny, else 0 (static NOLA normalisation)."""
    window = window_const(n_fft, win_length)
    wss = npref.window_sumsquare(window, n_frames, hop, n_fft)
    inv = np.zeros_like(wss)
    nz = wss > npref.TINY
    inv[nz] = 1.0 / wss[nz]
    return inv.astype(np.float32)


def window_tensor(n_fft: int, win_length: int, device) -> torch.Tensor:
    return torch.from_numpy(window_const(n_fft, win_length)).to(device)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy ``mode="reflect"`` padding of the last axis (edge not repeated)."""
    left = y[..., 1 : pad + 1].flip(-1)
    right = y[..., -pad - 1 : -1].flip(-1)
    return torch.cat([left, y, right], dim=-1)


def frame_dense(y: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """Frame (..., samples) -> (..., n_frames, n_fft) via reshape+shift:
    frame i is the concatenation of hop-blocks i .. i + n_fft/hop - 1."""
    r = n_fft // hop
    n_blocks = n_frames - 1 + r
    blocks = y[..., : n_blocks * hop].reshape(*y.shape[:-1], n_blocks, hop)
    return torch.cat([blocks[..., j : j + n_frames, :] for j in range(r)], dim=-1)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (..., n_frames, n_fft) -> (..., n_fft + hop*(n_frames-1))
    as a dense shifted sum over the n_fft/hop pieces of each frame."""
    *lead, n_frames, n_fft = frames.shape
    if n_fft % hop != 0:
        raise NotImplementedError("hop must divide n_fft for the dense overlap-add")
    r = n_fft // hop
    pieces = frames.reshape(*lead, n_frames, r, hop)
    n_blocks = n_frames - 1 + r
    total = frames.new_zeros((*lead, n_blocks, hop))
    for j in range(r):
        total[..., j : j + n_frames, :] += pieces[..., :, j, :]
    return total.reshape(*lead, n_blocks * hop)


def stft(
    y: torch.Tensor,
    n_fft: int = 2048,
    hop_length: int = 256,
    win_length: int | None = None,
    center: bool = True,
) -> torch.Tensor:
    """Complex STFT of (..., samples) -> (..., 1 + n_fft//2, n_frames);
    ``center`` reflect-pads by n_fft//2 on both sides."""
    if win_length is None:
        win_length = n_fft
    if n_fft % hop_length != 0:
        raise NotImplementedError("hop must divide n_fft for the dense framing")
    window = window_tensor(n_fft, win_length, y.device)
    if center:
        y = reflect_pad(y, n_fft // 2)
    n_frames = 1 + (y.shape[-1] - n_fft) // hop_length
    frames = frame_dense(y, n_fft, hop_length, n_frames)
    return torch.fft.rfft(frames * window, dim=-1).transpose(-1, -2)


def istft(
    S: torch.Tensor,
    hop_length: int = 256,
    win_length: int | None = None,
    center: bool = True,
    length: int | None = None,
) -> torch.Tensor:
    """Inverse STFT of (..., bins, n_frames) -> (..., samples), NOLA-normalised."""
    n_fft = 2 * (S.shape[-2] - 1)
    if win_length is None:
        win_length = n_fft
    n_frames = S.shape[-1]
    window = window_tensor(n_fft, win_length, S.device)
    frames = torch.fft.irfft(S.transpose(-1, -2), n=n_fft, dim=-1) * window
    y = overlap_add(frames, hop_length)
    y = y * torch.from_numpy(
        wss_inv_const(n_fft, win_length, hop_length, n_frames)).to(S.device)
    if center:
        y = y[..., n_fft // 2 : y.shape[-1] - n_fft // 2]
    if length is not None:
        cur = y.shape[-1]
        y = y[..., :length] if cur >= length else torch.nn.functional.pad(y, (0, length - cur))
    return y


def log_power(S: torch.Tensor) -> torch.Tensor:
    """log1p(|S|^2) compression (reference preprocess.py:49). Complex or real input."""
    if S.is_complex():
        power = S.real ** 2 + S.imag ** 2
    else:
        power = S ** 2
    return torch.log1p(power)


def inverse_log_power(spec: torch.Tensor, clip_max: float = 20.0) -> torch.Tensor:
    """sqrt(expm1(clip(spec, 0, clip_max))) (reference inference.py:109)."""
    return torch.sqrt(torch.expm1(torch.clamp(spec, 0.0, clip_max)))


def log_power_stft(
    y: torch.Tensor, n_fft: int = 2048, hop_length: int = 256,
    transform: str | None = None, center: bool = True,
) -> torch.Tensor:
    """Chunk -> log-power spectrogram, (..., samples) -> (..., bins, frames).

    ``center=False`` skips the reflect padding because the caller applied it
    on the host (the serving path does, to bucket sample counts).
    ``transform`` is "fft" (or None); the JAX package's "dft" matmul
    transform is not ported yet.
    """
    if transform not in (None, "fft"):
        raise NotImplementedError(
            f"transform={transform!r}: only the FFT transform is ported")
    return log_power(stft(y, n_fft=n_fft, hop_length=hop_length, center=center))
