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
On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version beside it. The two wrappers are also
the operators ``mmst_torch::gl_ola_nola`` and ``mmst_torch::gl_frame_window``,
which ``gl_consistency_frames`` calls while it is traced or watched. ``LAUNCHES`` counts kernel
launches per kernel and nothing else; the serving daemon launches from two
threads, so the counts are bumped under a lock.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import stft as _stft

R = 8  # n_fft // hop overlap factor (2048 / 256)
MIN_FRAMES = 3 * R  # as the JAX kernel's ``supported`` guard

LAUNCHES = {"gl_ola_nola": 0, "gl_frame_window": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(kernel: str) -> None:
    with _launch_lock:
        LAUNCHES[kernel] += 1


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures bound."""
    from . import _build

    lib = _build.load("gl_glue")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gl_ola_nola.argtypes = [vp, vp, vp, vp, ci, ci, vp]
    lib.gl_ola_nola.restype = ci
    lib.gl_frame_window.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.gl_frame_window.restype = ci
    return lib


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


def _launch_check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")


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

def ola_nola(frames: torch.Tensor, window: torch.Tensor,
             inv_blocks: torch.Tensor) -> torch.Tensor:
    """Window -> overlap-add -> x 1/WSS: (nf, n_fft) -> (nf+7, hop) f32."""
    nf, n_fft = frames.shape
    hop = _check_frame_shape(nf, n_fft)
    dev = frames.device
    _check("frames", frames, (nf, n_fft), dev)
    _check("window", window, (n_fft,), dev)
    _check("inv_blocks", inv_blocks, (nf + R - 1, hop), dev)
    if dev.type == "cpu":
        return ola_nola_reference(frames, window, inv_blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    y = torch.empty((nf + R - 1, hop), dtype=torch.float32, device=dev)
    err = _lib().gl_ola_nola(frames.data_ptr(), window.data_ptr(),
                             inv_blocks.data_ptr(), y.data_ptr(), nf, hop,
                             torch.cuda.current_stream(dev).cuda_stream)
    _launch_check(err, "gl_ola_nola")
    _count("gl_ola_nola")
    return y


def frame_window(y: torch.Tensor, window: torch.Tensor, nf: int) -> torch.Tensor:
    """Crop -> reflect pad -> frame -> window: (nf+7, hop) -> (nf, n_fft) f32."""
    n_fft = window.shape[0]
    hop = _check_frame_shape(nf, n_fft)
    dev = y.device
    _check("y", y, (nf + R - 1, hop), dev)
    _check("window", window, (n_fft,), dev)
    if dev.type == "cpu":
        return frame_window_reference(y, window, nf)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g = torch.empty((nf, n_fft), dtype=torch.float32, device=dev)
    err = _lib().gl_frame_window(y.data_ptr(), window.data_ptr(), g.data_ptr(),
                                 nf, hop, torch.cuda.current_stream(dev).cuda_stream)
    _launch_check(err, "gl_frame_window")
    _count("gl_frame_window")
    return g


# ---- the wrappers as PyTorch operators ---------------------------------------
# A ctypes launch takes raw data pointers, so neither a ``torch.export``
# trace (a FakeTensor has none) nor a ``TorchDispatchMode`` sees it. As
# ``mmst_torch::`` operators the same launches are visible to both; each
# implementation is the wrapper above, and a fake gives the output's shape.

@torch.library.custom_op("mmst_torch::gl_ola_nola", mutates_args=())
def _ola_nola_op(frames: torch.Tensor, window: torch.Tensor,
                 inv_blocks: torch.Tensor) -> torch.Tensor:
    return ola_nola(frames, window, inv_blocks)


@_ola_nola_op.register_fake
def _(frames, window, inv_blocks):
    return frames.new_empty((frames.shape[0] + R - 1, frames.shape[1] // R))


@torch.library.custom_op("mmst_torch::gl_frame_window", mutates_args=())
def _frame_window_op(y: torch.Tensor, window: torch.Tensor, nf: int) -> torch.Tensor:
    return frame_window(y, window, nf)


@_frame_window_op.register_fake
def _(y, window, nf):
    return y.new_empty((nf, window.shape[0]))


def gl_consistency_frames(frames: torch.Tensor, window: torch.Tensor,
                          inv_blocks: torch.Tensor) -> torch.Tensor:
    """Fused GL glue: raw irfft frames (nf, n_fft) -> windowed rfft input
    frames (nf, n_fft), f32, edge frames included.

    While PyTorch traces (``torch.export``, ``torch.compile``) or a
    ``TorchDispatchMode`` watches (NaN debugging), the two kernels are
    called through their operators, so an exported program launches them
    and the mode checks their outputs. Otherwise the wrappers are called
    directly: an operator's dispatch costs host time on each of the 600
    calls of a request, and serving is bound by the host (PERF.md §6).

    ``inv_blocks`` is 1/window_sumsquare reshaped to (nf + 7, hop), zeros
    where the sum is ~0. Requires n_fft == 8 * hop and nf >= 24.
    """
    nf = frames.shape[0]
    if torch.compiler.is_compiling() or torch._C._len_torch_dispatch_stack():
        y = torch.ops.mmst_torch.gl_ola_nola(frames, window, inv_blocks)
        return torch.ops.mmst_torch.gl_frame_window(y, window, nf)
    return frame_window(ola_nola(frames, window, inv_blocks), window, nf)
