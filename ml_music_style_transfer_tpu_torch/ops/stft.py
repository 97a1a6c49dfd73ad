"""STFT / iSTFT and log-power compression in PyTorch.

Counterpart of the JAX package's ``ops/stft.py`` (librosa semantics,
reference preprocessing/preprocess.py:47-57 and model/inference.py:105-110).
Framing keeps the dense reshape-shift decomposition where ``n_fft % hop ==
0`` (true for 2048/256) and gathers the frames by index otherwise, as the
JAX package does; the overlap-add is a dense shifted sum, which needs
``n_fft % hop == 0`` (other hops raise, as in JAX). The
transforms are ``torch.fft.rfft``/``irfft`` (cuFFT on the card) or, with
``transform="dft"``, one matmul against a packed [Re|Im] DFT matrix
(``dft_matrices``), as the JAX package's accelerator path.

Host data reaches the card through ``to_device``: pinned memory and a copy
that does not wait for the stream, so a caller that queues work for the
card is never held up by the work queued before it (the serving daemon
relies on this). The constants (window, NOLA curve, DFT matrices) are
uploaded once per device and shape and kept (``_kept``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

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


@functools.lru_cache(maxsize=8)
def _dft_matrices_host(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """One-sided real-DFT matmul pair, exact in float64.

    For real frames x (rows of length n_fft), bins = n_fft // 2 + 1:
      rfft:  x @ fwd = [Re X | Im X]            fwd (n_fft, 2*bins)
      irfft: [Re X | Im X] @ inv = x            inv (2*bins, n_fft)
    ``inv`` carries the hermitian weights (2 except DC and Nyquist) and the
    1/n_fft normalisation (the JAX package's ``stft._dft_matrices_host``).
    """
    bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos, sin = np.cos(ang), np.sin(ang)
    fwd = np.concatenate([cos, -sin], axis=1)
    w = np.where((k == 0) | (k == bins - 1), 1.0, 2.0)
    inv = np.concatenate([(w * cos / n_fft).T, (-w * sin / n_fft).T], axis=0)
    return fwd, inv


def _kept(maker):
    """Cache a constant tensor per arguments (device included). Made outside
    inference mode, so a constant first made while serving can still be
    saved for backward by a training step in the same process."""
    @functools.lru_cache(maxsize=16)
    @functools.wraps(maker)
    def kept(*args):
        with torch.inference_mode(False):
            return maker(*args)
    return kept


@_kept
def dft_matrices(n_fft: int, dtype: torch.dtype, device: torch.device):
    """``(fwd, inv)`` of ``_dft_matrices_host`` rounded once to ``dtype``,
    on ``device``."""
    fwd, inv = _dft_matrices_host(n_fft)
    return (to_device(fwd.astype(np.float32), device).to(dtype),
            to_device(inv.astype(np.float32), device).to(dtype))


def to_device(a, device) -> torch.Tensor:
    """A numpy array or CPU tensor as a tensor on ``device``; to the card
    through pinned memory with a copy that does not wait for earlier work on
    the stream (PyTorch's pinned allocator keeps the staging buffer until
    the copy has run)."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device)


@_kept
def window_tensor(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    return to_device(window_const(n_fft, win_length), device)


@_kept
def wss_inv_tensor(n_fft: int, win_length: int, hop: int, n_frames: int,
                   device: torch.device) -> torch.Tensor:
    """``wss_inv_const`` on ``device``."""
    return to_device(wss_inv_const(n_fft, win_length, hop, n_frames), device)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy ``mode="reflect"`` padding of the last axis (edge not repeated)."""
    left = y[..., 1 : pad + 1].flip(-1)
    right = y[..., -pad - 1 : -1].flip(-1)
    return torch.cat([left, y, right], dim=-1)


def pad_edges(y: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """``np.pad`` of the last axis by ``pad`` on both sides in the modes the
    JAX package's ``stft`` is called with: "reflect", "constant" (zeros)
    and "edge" (``F.pad``'s "replicate")."""
    if mode == "reflect":
        return reflect_pad(y, pad)
    if mode == "constant":
        return F.pad(y, (pad, pad))
    if mode == "edge":  # replicate pads (N, C, W): one channel per row
        flat = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="replicate")
        return flat.reshape(*y.shape[:-1], flat.shape[-1])
    raise ValueError(f"pad_mode must be 'reflect', 'constant' or 'edge', got {mode!r}")


def frame_dense(y: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """Frame (..., samples) -> (..., n_frames, n_fft) via reshape+shift:
    frame i is the concatenation of hop-blocks i .. i + n_fft/hop - 1."""
    r = n_fft // hop
    n_blocks = n_frames - 1 + r
    blocks = y[..., : n_blocks * hop].reshape(*y.shape[:-1], n_blocks, hop)
    return torch.cat([blocks[..., j : j + n_frames, :] for j in range(r)], dim=-1)


def frame_gather(y: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """Frame (..., samples) -> (..., n_frames, n_fft) by index: frame i is
    samples i*hop .. i*hop + n_fft - 1, for any hop."""
    idx = (torch.arange(n_frames, device=y.device)[:, None] * hop
           + torch.arange(n_fft, device=y.device)[None, :])
    return y[..., idx]


def _frames(y: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    if n_fft % hop == 0:
        return frame_dense(y, n_fft, hop, n_frames)
    return frame_gather(y, n_fft, hop, n_frames)


def n_frames_for(n_samples: int, hop_length: int, center: bool = True) -> int:
    """Frame-count contract: 1 + n_samples // hop for the centred STFT."""
    if center:
        return 1 + n_samples // hop_length
    raise NotImplementedError("only center=True is used by the pipeline")


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
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Complex STFT of (..., samples) -> (..., 1 + n_fft//2, n_frames);
    ``center`` pads by n_fft//2 on both sides in ``pad_mode``
    (``pad_edges``)."""
    if win_length is None:
        win_length = n_fft
    window = window_tensor(n_fft, win_length, y.device)
    if center:
        y = pad_edges(y, n_fft // 2, pad_mode)
    n_frames = 1 + (y.shape[-1] - n_fft) // hop_length
    frames = _frames(y, n_fft, hop_length, n_frames)
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
    return istft_frames(torch.fft.irfft(S.transpose(-1, -2), n=n_fft, dim=-1), hop_length,
                        win_length, center, length)


def istft_frames(frames: torch.Tensor, hop_length: int = 256, win_length: int | None = None,
                 center: bool = True, length: int | None = None) -> torch.Tensor:
    """``istft`` after its inverse FFT: (..., n_frames, n_fft) real frames ->
    (..., samples), windowed, overlap-added and NOLA-normalised."""
    n_frames, n_fft = frames.shape[-2:]
    if win_length is None:
        win_length = n_fft
    frames = frames * window_tensor(n_fft, win_length, frames.device)
    y = overlap_add(frames, hop_length)
    y = y * wss_inv_tensor(n_fft, win_length, hop_length, n_frames, frames.device)
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
    ``transform``: "fft" (the default, None) or "dft", one float32 matmul of
    the windowed frames against ``dft_matrices`` that never forms a complex
    array (the JAX package's ``stft.py:226-247``; it keeps the 1e-3
    log-space contract against the float64 STFT, so no bfloat16 here).
    """
    if transform in (None, "fft"):
        return log_power(stft(y, n_fft=n_fft, hop_length=hop_length, center=center))
    if transform != "dft":
        raise ValueError(f"transform must be 'fft' or 'dft', got {transform!r}")
    bins = n_fft // 2 + 1
    window = window_tensor(n_fft, n_fft, y.device)
    if center:
        y = reflect_pad(y, n_fft // 2)
    n_frames = 1 + (y.shape[-1] - n_fft) // hop_length
    frames = _frames(y, n_fft, hop_length, n_frames)
    fwd, _ = dft_matrices(n_fft, torch.float32, y.device)
    p = torch.matmul(frames * window, fwd)
    return torch.log1p(p[..., :bins] ** 2 + p[..., bins:] ** 2).transpose(-1, -2)
