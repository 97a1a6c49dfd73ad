"""Griffin-Lim phase recovery with momentum, in PyTorch.

Counterpart of the JAX package's ``ops/griffinlim.py`` (reference
model/inference.py:105-110: n_iter=300, hann, win_length=2048, hop 256):
Griffin & Lim (1984) with the momentum of Perraudin et al. (2013), the
librosa.griffinlim update. ``jax.random`` keys become ``torch.Generator``s,
so the random phase differs from the JAX package's by design; pass
``init_phase`` to compare the two.

With the glue, each iteration is irfft -> consistency glue -> rfft, the
glue being the hand-written CUDA kernels of ``ops/kernels/gl_glue.py`` on
a CUDA tensor and their plain version on a CPU tensor; traced by
``torch.export``, the glue is their ``mmst_torch`` operators, so an
exported program launches the same kernels. Without it the iteration is
istft -> stft. ``use_pallas_glue=None`` (the default) decides by shape, as
the JAX package does (``resolve_pallas_glue``): the glue wherever the
kernels take the clip, the istft -> stft loop on any other input (a
``length``, a shorter window, another hop, fewer than 24 frames).

``transform="dft"`` swaps the two FFTs for two matmuls on a packed real
[Re|Im] state (the JAX package's ``_gl_steps_dft``), with the same glue
between them; ``transform=None`` is "fft": on the H100 the dft loop takes
about twice the fft loop's time per iteration at equal spectral
convergence (chip_smoke.py's A/B, PERF.md).
"""
from __future__ import annotations

import numpy as np
import torch
from torch._higher_order_ops.while_loop import while_loop

from ..device import resolve_device
from . import stft as _stft
from .kernels import gl_glue as _glue

EPS = 1.1754944e-38  # float32 tiny, the update's denominator guard


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """float32 on ``device``; a host array reaches the card through pinned
    memory without waiting for the stream (``stft.to_device``)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))  # a writable copy (jax arrays are read-only)
    return _stft.to_device(x.to(torch.float32), device)


def resolve_pallas_glue(n_frames: int, n_fft: int, hop_length: int,
                        win_length: int) -> bool:
    """Whether Griffin-Lim runs the glue kernels on one clip of this shape:
    the JAX package's rule (``gl_glue.supported``, win_length == n_fft).
    The shape alone decides, never the device: on a CPU tensor the glue is
    the kernels' plain version."""
    return win_length == n_fft and _glue.supported(n_frames, n_fft, hop_length)


def resolve_transform(ndim: int, n_fft: int, win_length: int, length: int | None) -> str:
    """The transform pair of the iteration: "fft" for every shape. The JAX
    package takes "dft" on a TPU; on the H100 the dft loop takes 2.1x the
    fft loop's time per iteration (chip_smoke.py's dft phase, PERF.md). The
    arguments are the JAX function's."""
    return "fft"


GLUE_RULE = ("the glue kernels take one (bins, frames) clip with hop = n_fft/8 and "
             "hop % 4 == 0, at least 24 frames, win_length == n_fft and length=None")


def _takes_glue(magnitude, hop: int, win_length: int, length, use_pallas_glue) -> bool:
    """``use_pallas_glue`` resolved for ``magnitude``: None by the shape
    (``resolve_pallas_glue``), True checked against it."""
    n_fft = 2 * (magnitude.shape[-2] - 1)
    fits = (magnitude.ndim == 2 and length is None
            and resolve_pallas_glue(magnitude.shape[-1], n_fft, hop, win_length))
    if use_pallas_glue is None:
        return fits
    if use_pallas_glue and not fits:
        raise ValueError(f"use_pallas_glue=True, but {GLUE_RULE}; got magnitude "
                         f"{tuple(magnitude.shape)}, hop {hop}, win_length {win_length}, "
                         f"length {length} (use_pallas_glue=None runs the istft -> stft loop)")
    return bool(use_pallas_glue)


def griffinlim(
    magnitude,
    generator: torch.Generator | None = None,
    n_iter: int = 300,
    hop_length: int = 256,
    win_length: int | None = None,
    momentum: float = 0.99,
    length: int | None = None,
    init_phase=None,
    use_pallas_glue: bool | None = None,
    transform: str | None = None,
    device: str | torch.device | None = "cuda",
) -> torch.Tensor:
    """Recover a waveform from a (..., bins, n_frames) linear magnitude.

    ``generator`` draws the uniform random phase (default: a CPU generator
    seeded 0, so the phase is the same on every device) unless
    ``init_phase`` (radians, the magnitude's shape) is given. A batched
    (..., bins, frames) input runs clip by clip, as the JAX ``lax.map``
    does. ``use_pallas_glue`` and ``transform``: None decides by shape
    (``resolve_pallas_glue``, ``resolve_transform``); True on a shape the
    glue kernels do not take raises. Returns (..., samples),
    ``hop_length * (n_frames - 1)`` long unless ``length`` is given, on
    ``device``. While ``torch.export`` traces, ``n_iter`` may be a 0-d
    int64 host tensor, a program input (``_iterate``).
    """
    dev = resolve_device(device)
    magnitude = _as_tensor(magnitude, dev)
    n_fft = 2 * (magnitude.shape[-2] - 1)
    if win_length is None:
        win_length = n_fft
    transform = transform or resolve_transform(magnitude.ndim, n_fft, win_length, length)
    if transform not in ("fft", "dft"):
        raise ValueError(f"transform must be 'fft' or 'dft', got {transform!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if magnitude.ndim > 2:
        lead, clips = magnitude.shape[:-2], magnitude.reshape(-1, *magnitude.shape[-2:])
        phases = ([None] * clips.shape[0] if init_phase is None
                  else _as_tensor(init_phase, dev).reshape(clips.shape))
        out = torch.stack([
            griffinlim(m, generator, n_iter, hop_length, win_length, momentum,
                       length, p, use_pallas_glue, transform, dev)
            for m, p in zip(clips, phases)])
        return out.reshape(*lead, out.shape[-1])
    if transform == "dft":
        _check_dft_shapes(magnitude, win_length, n_fft, length)
    use_pallas_glue = _takes_glue(magnitude, hop_length, win_length, length, use_pallas_glue)
    if init_phase is None:
        init_phase = 2.0 * np.pi * torch.rand(
            magnitude.shape, generator=generator, device=generator.device)
    init_phase = _as_tensor(init_phase, dev)
    if transform == "fft" and use_pallas_glue:
        # real end to end (no complex tensor but the FFTs' own): the form a
        # compiler takes whole (AOTInductor on the card computes complex
        # elementwise products and their fills wrongly)
        phase_t = init_phase.transpose(-1, -2)
        ang = torch.stack([torch.cos(phase_t), torch.sin(phase_t)], dim=-1)
        mag_t = magnitude.transpose(-1, -2).contiguous().unsqueeze(-1)
        ang, _ = _gl_steps_real(mag_t, ang, torch.zeros_like(ang), n_iter, hop_length,
                                momentum / (1.0 + momentum))
        frames = torch.fft.irfft(torch.view_as_complex(mag_t * ang), n=n_fft, dim=-1)
        return _stft.istft_frames(frames, hop_length, win_length)
    angles = torch.complex(torch.cos(init_phase), torch.sin(init_phase))
    carry = (angles, torch.zeros_like(angles))
    angles, _ = gl_steps(magnitude, carry, n_iter, hop_length, win_length,
                         momentum, use_pallas_glue, length, transform)
    return _stft.istft(magnitude * angles, hop_length, win_length, length=length)


def _check_dft_shapes(magnitude, win_length: int, n_fft: int, length) -> None:
    """The dft loop takes one (bins, frames) clip framed at n_fft."""
    if win_length != n_fft or length is not None or magnitude.ndim != 2:
        raise ValueError("transform='dft' needs one (bins, frames) clip, win_length == n_fft "
                         "and length=None; the fft loop takes the others")


def gl_steps(magnitude, carry, n_iter: int, hop_length: int, win_length: int,
             momentum: float = 0.99, use_pallas_glue: bool | None = None,
             length: int | None = None, transform: str = "fft"):
    """Run ``n_iter`` Griffin-Lim iterations on an explicit carry.

    ``carry`` is ``(angles, rebuilt_prev)``, both complex (bins, frames);
    returns the updated carry. ``use_pallas_glue`` as ``griffinlim``'s.
    """
    n_fft = 2 * (magnitude.shape[-2] - 1)
    mom = momentum / (1.0 + momentum)
    angles, rebuilt = carry

    if transform == "dft":
        _check_dft_shapes(magnitude, win_length, n_fft, length)
        return _gl_steps_dft(magnitude, carry, n_iter, hop_length, mom,
                             _takes_glue(magnitude, hop_length, win_length, length,
                                         use_pallas_glue))
    use_pallas_glue = _takes_glue(magnitude, hop_length, win_length, length, use_pallas_glue)

    if not use_pallas_glue:
        for _ in range(n_iter):
            inverse = _stft.istft(magnitude * angles, hop_length, win_length,
                                  length=length)
            rebuilt_new = _stft.stft(inverse, n_fft, hop_length, win_length)
            angles = torch.view_as_complex(_momentum_update(
                torch.view_as_real(rebuilt_new), torch.view_as_real(rebuilt), mom))
            rebuilt = rebuilt_new
        return angles, rebuilt

    mag_t = magnitude.transpose(-1, -2).contiguous().unsqueeze(-1)
    ang, reb = _gl_steps_real(mag_t, torch.view_as_real(angles.transpose(-1, -2).contiguous()),
                              torch.view_as_real(rebuilt.transpose(-1, -2).contiguous()),
                              n_iter, hop_length, mom)
    return (torch.view_as_complex(ang).transpose(-1, -2),
            torch.view_as_complex(reb).transpose(-1, -2))


def _iterate(step, n_iter, state: tuple) -> tuple:
    """``n_iter`` calls of ``step`` on ``state``. While ``torch.export``
    traces, one ``while_loop`` whose body is one call, so a program holds
    one iteration and takes ``n_iter`` as an input (a 0-d int64 tensor on
    the host: the loop's counter stays there too, so the loop never waits
    for the card) and AOTInductor compiles the body once. Eager, a Python
    loop: run eagerly, ``while_loop`` compiles its body with Dynamo at the
    first call of each shape (seconds)."""
    if torch.compiler.is_exporting():
        return while_loop(lambda i, *s: i < n_iter, lambda i, *s: (i + 1, *step(*s)),
                          (torch.zeros((), dtype=torch.int64), *state))[1:]
    for _ in range(n_iter):
        state = step(*state)
    return state


def _momentum_update(reb_new, reb, mom: float):
    """The momentum step and the renormalisation on [Re, Im] pairs (last
    axis 2): angles = a / (|a| + EPS), a = rebuilt - mom * previous. Four
    elementwise kernels eagerly (the step in one ``add``, |a| as hypot(re,
    im), + EPS, the division); every fft loop shares it, so the glue loop
    and the plain istft/stft loop round alike."""
    a = torch.add(reb_new, reb, alpha=-mom)
    return a / (torch.hypot(a[..., 0], a[..., 1]) + EPS).unsqueeze(-1)


def _gl_steps_real(mag_t, ang, reb, n_iter, hop: int, mom: float):
    """The glue loop of ``griffinlim`` and ``gl_steps`` on real frame-major
    state: ``mag_t`` (frames, bins, 1), the angles and the last rebuilt
    spectrum (frames, bins, 2) as [Re, Im]. irfft/rfft run along the
    contiguous last axis and the glue takes (frames, n_fft) rows; between
    the transforms the product and ``_momentum_update`` are real arithmetic,
    which a compiler (AOTInductor) fuses. Returns (angles, rebuilt)."""
    n_frames, bins = mag_t.shape[:2]
    n_fft = 2 * (bins - 1)
    dev = mag_t.device
    window = _stft.window_tensor(n_fft, n_fft, dev)
    inv_blocks = _inv_blocks(n_fft, hop, n_frames, dev)

    def step(ang, reb):
        frames = torch.fft.irfft(torch.view_as_complex(mag_t * ang), n=n_fft, dim=-1)
        g = _glue.gl_consistency_frames(frames, window, inv_blocks)
        reb_new = torch.view_as_real(torch.fft.rfft(g, dim=-1))
        return _momentum_update(reb_new, reb, mom), reb_new

    return _iterate(step, n_iter, (ang, reb))


def _inv_blocks(n_fft: int, hop: int, n_frames: int, device) -> torch.Tensor:
    """1/window_sumsquare as the glue takes it, (n_frames + n_fft/hop - 1, hop)."""
    return _stft.wss_inv_tensor(n_fft, n_fft, hop, n_frames, device).view(
        n_frames + n_fft // hop - 1, hop)


def _gl_steps_dft(magnitude, carry, n_iter: int, hop: int, mom: float,
                  use_pallas_glue: bool):
    """Griffin-Lim iterations with matmul-DFT transforms.

    The loop state is packed real, (frames, 2*bins) [Re | Im], converted
    from and to the complex (bins, frames) carry at the boundary only. Each
    iteration: inverse matmul -> consistency glue -> forward matmul ->
    momentum update. The glue is K3 (``gl_glue.gl_consistency_frames``:
    the CUDA kernels on the card, their plain version on the CPU), or with
    ``use_pallas_glue=False`` its plain version on any device. The matmuls
    take float32 inputs on the CPU and bfloat16 inputs with float32
    accumulation and output on the card, as the JAX package's accelerator
    path (griffinlim.py:233); Griffin-Lim renormalises the phase every
    iteration, so the rounding does not accumulate.
    """
    bins, n_frames = magnitude.shape
    n_fft = 2 * (bins - 1)
    dev = magnitude.device
    on_card = dev.type == "cuda"
    in_dtype = torch.bfloat16 if on_card else torch.float32
    fwd, inv = _stft.dft_matrices(n_fft, in_dtype, dev)
    window = _stft.window_tensor(n_fft, n_fft, dev)
    inv_blocks = _inv_blocks(n_fft, hop, n_frames, dev)
    glue = (_glue.gl_consistency_frames if use_pallas_glue
            else _glue.gl_consistency_frames_reference)
    mag_t = magnitude.transpose(0, 1)  # (frames, bins)

    def matmul(a, b):
        if on_card:  # bfloat16 in, float32 accumulation and out
            return torch.mm(a.to(in_dtype), b, out_dtype=torch.float32)
        return torch.mm(a, b)

    def pack(z):  # complex (bins, frames) -> real (frames, 2*bins)
        return torch.cat([z.real, z.imag], dim=0).transpose(0, 1).contiguous()

    def step(ang, reb):
        spec = torch.cat([ang[:, :bins] * mag_t, ang[:, bins:] * mag_t], dim=1)
        frames = matmul(spec, inv)
        reb_new = matmul(glue(frames, window, inv_blocks), fwd)
        a = reb_new - mom * reb
        norm = torch.sqrt(a[:, :bins] ** 2 + a[:, bins:] ** 2) + EPS
        return torch.cat([a[:, :bins] / norm, a[:, bins:] / norm], dim=1), reb_new

    ang, reb = _iterate(step, n_iter, (pack(carry[0]), pack(carry[1])))

    def unpack(p):  # real (frames, 2*bins) -> complex (bins, frames)
        return torch.complex(p[:, :bins], p[:, bins:]).transpose(0, 1)

    return unpack(ang), unpack(reb)


def griffinlim_from_log_power(
    spec,
    generator: torch.Generator | None = None,
    n_iter: int = 300,
    hop_length: int = 256,
    clip_max: float = 20.0,
    length: int | None = None,
    use_pallas_glue: bool | None = None,
    device: str | torch.device | None = "cuda",
    init_phase=None,
) -> torch.Tensor:
    """Full synthesis: (..., bins, frames) log-power spec -> waveform
    (inference.py:109-110: compression inverse, then Griffin-Lim);
    ``use_pallas_glue`` and ``init_phase`` as ``griffinlim``'s."""
    dev = resolve_device(device)
    magnitude = _stft.inverse_log_power(_as_tensor(spec, dev), clip_max)
    return griffinlim(magnitude, generator=generator, n_iter=n_iter,
                      hop_length=hop_length, length=length, init_phase=init_phase,
                      use_pallas_glue=use_pallas_glue, device=dev)
