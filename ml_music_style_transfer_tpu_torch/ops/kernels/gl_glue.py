"""Griffin-Lim consistency glue: the CUDA kernels' wrappers and plain versions.

Each Griffin-Lim iteration (ops/griffinlim.py) runs irfft -> glue -> rfft,
where the glue is

    window -> overlap-add at hop -> x 1/window_sumsquare -> centre crop ->
    reflect pad -> re-frame -> window

It replaces the JAX package's Pallas kernels in
``ml_music_style_transfer_tpu/ops/pallas/gl_glue.py``:

  - ``ola_nola`` (CUDA ``gl_ola_nola_kernel``) for ``_ola_kernel``
    (``pallas_call`` at gl_glue.py:95): window, overlap-add, NOLA;
  - ``frame_window`` (CUDA ``gl_frame_window_kernel``) for
    ``_frame_kernel`` (gl_glue.py:110) together with the wrapper's exact
    edge-frame fix-up (gl_glue.py:161-180): crop, reflect pad, frame, window.

The kernels are in ``csrc/gl_glue.cu`` (design and bound in its header).
Each wrapper checks its arguments and calls its operator,
``mmst_torch::gl_ola_nola`` or ``mmst_torch::gl_frame_window``
(``csrc/mmst_ops.cpp``): on a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs the plain version, written there in ATen
op for op as the Python plain versions beside it. Being operators, the
calls are traced by ``torch.export`` and seen by a ``TorchDispatchMode``.
``LAUNCHES`` reads the library's count of CUDA launches per kernel (atomic
counters: the serving daemon launches from two threads).
"""
from __future__ import annotations

import torch

from .. import stft as _stft
from . import _library

R = 8  # n_fft // hop overlap factor (2048 / 256)
MIN_FRAMES = 3 * R  # as the JAX kernel's ``supported`` guard

LAUNCHES = _library.LaunchCounts("gl_ola_nola", "gl_frame_window")


def reset_launches() -> None:
    LAUNCHES.reset()


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_frame_shape(nf: int, n_fft: int) -> int:
    if n_fft % R != 0 or (n_fft // R) % 4 != 0:
        raise ValueError(f"n_fft={n_fft} must be {R} hops of a multiple of 4 samples")
    if nf < MIN_FRAMES:
        raise ValueError(f"the glue needs at least {MIN_FRAMES} frames, got {nf}")
    return n_fft // R


def supported(nf: int, n_fft: int, hop: int) -> bool:
    """Whether the glue takes these shapes (the JAX kernel's ``supported``
    guard, ``gl_glue.py:125``): n_fft = 8 hops of a multiple of 4 samples,
    at least 24 frames."""
    return n_fft == R * hop and hop % 4 == 0 and nf >= MIN_FRAMES


# ---- plain versions ---------------------------------------------------------

def ola_nola_reference(frames, window, inv_blocks):
    """(nf, n_fft) frames -> (nf+7, hop) overlap-added, NOLA-normalised y."""
    hop = inv_blocks.shape[1]
    y = _stft.overlap_add(frames * window, hop) * inv_blocks.reshape(-1)
    return y.reshape(-1, hop)


def frame_window_reference(y, window, nf: int):
    """(nf+7, hop) y -> (nf, n_fft): crop, reflect pad, frame, window."""
    n_fft = window.shape[0]
    hop = y.shape[1]
    half = n_fft // 2
    flat = y.reshape(-1)
    yc = flat[half : flat.shape[0] - half]
    return _stft.frame_dense(_stft.reflect_pad(yc, half), n_fft, hop, nf) * window


def gl_consistency_frames_reference(frames, window, inv_blocks):
    """Plain PyTorch glue: window -> OLA -> x inv -> crop -> reflect pad ->
    frame -> window (the JAX package's griffinlim.py:257-267)."""
    return frame_window_reference(ola_nola_reference(frames, window, inv_blocks),
                                  window, frames.shape[0])


# ---- wrappers ---------------------------------------------------------------

def _check_device(dev: torch.device) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def ola_nola(frames: torch.Tensor, window: torch.Tensor,
             inv_blocks: torch.Tensor) -> torch.Tensor:
    """Window -> overlap-add -> x 1/WSS: (nf, n_fft) -> (nf+7, hop) f32."""
    nf, n_fft = frames.shape
    hop = _check_frame_shape(nf, n_fft)
    dev = frames.device
    _check("frames", frames, (nf, n_fft), dev)
    _check("window", window, (n_fft,), dev)
    _check("inv_blocks", inv_blocks, (nf + R - 1, hop), dev)
    _check_device(dev)
    return _library.ops().gl_ola_nola(frames, window, inv_blocks)


def frame_window(y: torch.Tensor, window: torch.Tensor, nf: int) -> torch.Tensor:
    """Crop -> reflect pad -> frame -> window: (nf+7, hop) -> (nf, n_fft) f32."""
    n_fft = window.shape[0]
    hop = _check_frame_shape(nf, n_fft)
    dev = y.device
    _check("y", y, (nf + R - 1, hop), dev)
    _check("window", window, (n_fft,), dev)
    _check_device(dev)
    return _library.ops().gl_frame_window(y, window, nf)


def gl_consistency_frames(frames: torch.Tensor, window: torch.Tensor,
                          inv_blocks: torch.Tensor) -> torch.Tensor:
    """Fused GL glue: raw irfft frames (nf, n_fft) -> windowed rfft input
    frames (nf, n_fft), f32, edge frames included: the two operators, so an
    exported program launches the kernels and a dispatch mode (NaN
    debugging) checks their outputs.

    ``inv_blocks`` is 1/window_sumsquare reshaped to (nf + 7, hop), zeros
    where the sum is ~0. Requires n_fft == 8 * hop and nf >= 24.
    """
    return frame_window(ola_nola(frames, window, inv_blocks), window, frames.shape[0])
