"""Griffin-Lim phase recovery with momentum, in PyTorch.

Counterpart of the JAX package's ``ops/griffinlim.py`` (reference
model/inference.py:105-110: n_iter=300, hann, win_length=2048, hop 256):
Griffin & Lim (1984) with the momentum of Perraudin et al. (2013), the
librosa.griffinlim update. ``jax.random`` keys become ``torch.Generator``s,
so the random phase differs from the JAX package's by design; pass
``init_phase`` to compare the two.

With ``use_pallas_glue=True`` (the default) each iteration is
irfft -> consistency glue -> rfft, the glue being the hand-written CUDA
kernels of ``ops/kernels/gl_glue.py`` on a CUDA tensor and their plain
version on a CPU tensor. With ``False`` the iteration is istft -> stft.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import stft as _stft
from .kernels import gl_glue as _glue

EPS = 1.1754944e-38  # float32 tiny, the update's denominator guard


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))  # a writable copy (jax arrays are read-only)
    return x.to(device=device, dtype=torch.float32)


def griffinlim(
    magnitude,
    generator: torch.Generator | None = None,
    n_iter: int = 300,
    hop_length: int = 256,
    win_length: int | None = None,
    momentum: float = 0.99,
    length: int | None = None,
    init_phase=None,
    use_pallas_glue: bool = True,
    transform: str | None = None,
    device: str | torch.device | None = "cuda",
) -> torch.Tensor:
    """Recover a waveform from a (..., bins, n_frames) linear magnitude.

    ``generator`` draws the uniform random phase (default: a CPU generator
    seeded 0, so the phase is the same on every device) unless
    ``init_phase`` (radians, the magnitude's shape) is given. A batched
    (N, bins, frames) input runs clip by clip, as the JAX ``lax.map`` does.
    Returns (..., samples), ``hop_length * (n_frames - 1)`` long unless
    ``length`` is given, on ``device``.
    """
    if transform not in (None, "fft"):
        raise NotImplementedError(
            f"transform={transform!r}: only the FFT transform is ported")
    dev = resolve_device(device)
    magnitude = _as_tensor(magnitude, dev)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if magnitude.ndim == 3:
        phases = [None] * magnitude.shape[0] if init_phase is None else init_phase
        return torch.stack([
            griffinlim(m, generator, n_iter, hop_length, win_length, momentum,
                       length, p, use_pallas_glue, transform, dev)
            for m, p in zip(magnitude, phases)])
    n_fft = 2 * (magnitude.shape[-2] - 1)
    if win_length is None:
        win_length = n_fft
    if init_phase is None:
        init_phase = 2.0 * np.pi * torch.rand(
            magnitude.shape, generator=generator, device=generator.device)
    init_phase = _as_tensor(init_phase, dev)
    angles = torch.complex(torch.cos(init_phase), torch.sin(init_phase))
    carry = (angles, torch.zeros_like(angles))
    angles, _ = gl_steps(magnitude, carry, n_iter, hop_length, win_length,
                         momentum, use_pallas_glue, length)
    return _stft.istft(magnitude * angles, hop_length, win_length, length=length)


def gl_steps(magnitude, carry, n_iter: int, hop_length: int, win_length: int,
             momentum: float = 0.99, use_pallas_glue: bool = True,
             length: int | None = None):
    """Run ``n_iter`` Griffin-Lim iterations on an explicit carry.

    ``carry`` is ``(angles, rebuilt_prev)``, both complex (bins, frames);
    returns the updated carry.
    """
    n_fft = 2 * (magnitude.shape[-2] - 1)
    mom = momentum / (1.0 + momentum)
    angles, rebuilt = carry

    if not use_pallas_glue:
        for _ in range(n_iter):
            inverse = _stft.istft(magnitude * angles, hop_length, win_length,
                                  length=length)
            rebuilt_new = _stft.stft(inverse, n_fft, hop_length, win_length)
            angles = rebuilt_new - mom * rebuilt
            angles = angles / (torch.abs(angles) + EPS)
            rebuilt = rebuilt_new
        return angles, rebuilt

    if win_length != n_fft or length is not None or magnitude.ndim != 2:
        raise ValueError("use_pallas_glue=True needs one (bins, frames) clip, "
                         "win_length == n_fft and length=None; pass "
                         "use_pallas_glue=False otherwise")
    n_frames = magnitude.shape[-1]
    dev = magnitude.device
    window = _stft.window_tensor(n_fft, win_length, dev)
    inv_blocks = torch.from_numpy(
        _stft.wss_inv_const(n_fft, win_length, hop_length, n_frames).reshape(
            n_frames + n_fft // hop_length - 1, hop_length)).to(dev)
    # frame-major (frames, bins) inside the loop: irfft/rfft run along the
    # contiguous last axis and the glue takes (frames, n_fft) rows
    mag_t = magnitude.transpose(-1, -2).contiguous()
    angles = angles.transpose(-1, -2).contiguous()
    rebuilt = rebuilt.transpose(-1, -2).contiguous()
    for _ in range(n_iter):
        frames = torch.fft.irfft(mag_t * angles, n=n_fft, dim=-1)
        g = _glue.gl_consistency_frames(frames, window, inv_blocks)
        rebuilt_new = torch.fft.rfft(g, dim=-1)
        angles = rebuilt_new - mom * rebuilt
        angles = angles / (torch.abs(angles) + EPS)
        rebuilt = rebuilt_new
    return angles.transpose(-1, -2), rebuilt.transpose(-1, -2)


def griffinlim_from_log_power(
    spec,
    generator: torch.Generator | None = None,
    n_iter: int = 300,
    hop_length: int = 256,
    clip_max: float = 20.0,
    length: int | None = None,
    use_pallas_glue: bool = True,
    device: str | torch.device | None = "cuda",
) -> torch.Tensor:
    """Full synthesis: (bins, frames) log-power spec -> waveform
    (inference.py:109-110: compression inverse, then Griffin-Lim)."""
    dev = resolve_device(device)
    magnitude = _stft.inverse_log_power(_as_tensor(spec, dev), clip_max)
    return griffinlim(magnitude, generator=generator, n_iter=n_iter,
                      hop_length=hop_length, length=length,
                      use_pallas_glue=use_pallas_glue, device=dev)
