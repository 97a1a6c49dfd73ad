"""Time-sharded Griffin-Lim: phase recovery of ONE long clip over the ranks
of a mesh axis, the port of the JAX package's ``parallel/gl_shard.py``.

  - every rank runs Griffin-Lim (``ops/griffinlim.gl_steps``, so the K3
    glue kernels launch once per iteration on each rank where they take
    the extended slice's shape) over its own
    frames plus ``halo`` frames of context on each side, sliced from the
    whole spectrogram that every rank holds (zeros past the clip's edges:
    silent, so inert);
  - all ranks start from ONE global random phase field, drawn from
    ``torch.Generator().manual_seed(seed)`` exactly as ``griffinlim``
    draws its own (or handed in as ``init_phase``), each slicing its
    frames plus the halo: with identical starts and identical magnitudes
    in the overlap, neighbouring ranks' iterates stay phase-coherent near
    the seam, so blending them is constructive;
  - the iterations run in ``rounds`` Schwarz blocks; between blocks each
    rank's halo columns are refreshed from its neighbours' interior edges
    (a neighbour exchange of the whole carry);
  - each rank keeps the waveform of its own frames; across each seam the
    left neighbour's rendering of the first ``(halo - 1) * hop`` samples is
    sent right and crossfaded in with a raised cosine.

On an axis of one rank it is ``griffinlim`` itself on the whole clip, bit
for bit, with the waveform zero-padded to T * hop samples.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import griffinlim as tgl
from ..ops import stft as _stft
from . import comm
from . import mesh as pmesh


def phase_field(bins: int, t_frames: int, seed: int = 0) -> torch.Tensor:
    """The shared (bins, T) initial phase in radians: ``griffinlim``'s own
    draw from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    return 2.0 * np.pi * torch.rand((bins, t_frames), generator=gen)


def check_options(t_frames: int, n: int, halo: int, rounds: int,
                  axis_name: str = "time") -> None:
    """The ``ValueError``s of a T-frame clip over n ranks (the JAX
    package's, ``gl_shard.py:185-190``, and ``halo``, ``rounds`` >= 1)."""
    if t_frames % n:
        raise ValueError(f"frame count {t_frames} must divide the mesh axis "
                         f"'{axis_name}' size {n} (pad the spec)")
    if t_frames // n <= halo:
        raise ValueError(f"local shard {t_frames // n} frames <= halo {halo}; use fewer "
                         "ranks or a smaller halo")
    if halo < 1 or rounds < 1:
        raise ValueError(f"halo {halo} and rounds {rounds} must be at least 1")


def rank_inputs(spec: torch.Tensor, phase, r: int, t_loc: int, halo: int,
                clip_max: float = 20.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank r's Griffin-Lim inputs: the (bins, t_loc + 2 halo) magnitude of
    its frames plus ``halo`` on each side of the zero-padded (T, bins)
    log-power ``spec``, and the initial angles from the (bins, T)
    ``phase`` field over the same frames."""
    lo = r * t_loc
    ext = F.pad(spec, (0, 0, halo, halo))[lo:lo + t_loc + 2 * halo]
    ext_phase = F.pad(tgl._as_tensor(phase, spec.device),
                      (halo, halo))[:, lo:lo + t_loc + 2 * halo]
    return (_stft.inverse_log_power(ext.transpose(0, 1), clip_max),
            torch.complex(torch.cos(ext_phase), torch.sin(ext_phase)))


def _exchange_complex(to_right, to_left, group):
    """``comm.neighbor_exchange`` of complex tensors, as their real views."""
    out = comm.neighbor_exchange(torch.view_as_real(to_right.contiguous()),
                                 torch.view_as_real(to_left.contiguous()), group)
    return tuple(torch.view_as_complex(o) for o in out)


@torch.inference_mode()
def sharded_griffinlim_from_log_power(
    spec, mesh=None, axis_name: str = "time", n_iter: int = 300, hop_length: int = 256,
    clip_max: float = 20.0, halo: int = 32, seed: int = 0, rounds: int = 10,
    init_phase=None, device: str | torch.device | None = "cuda",
) -> torch.Tensor:
    """(T, bins) log-power spec, the whole clip on every rank of ``mesh``'s
    ``axis_name`` (None: one device, ``device``) -> the (T * hop,) waveform
    on every rank, Griffin-Lim running concurrently on each.

    ``halo``: frames of context per side (32 = 0.19 s at hop 256);
    ``rounds``: Schwarz blocks the ``n_iter`` iterations split into;
    ``init_phase``: a (bins, T) phase field instead of the ``seed``'s.
    Raises ValueError where T does not split evenly over the axis or a
    rank's share is not longer than the halo.
    """
    group = pmesh.axis_group(mesh, axis_name)
    n = comm.group_size(group)
    dev = pmesh.mesh_device(mesh) if mesh is not None else resolve_device(device)
    spec = tgl._as_tensor(spec, dev)
    t_frames, bins = spec.shape
    phase = phase_field(bins, t_frames, seed) if init_phase is None else init_phase
    if n == 1:
        # the (bins, T) layout contiguous, as one device's Griffin-Lim takes it
        wav = tgl.griffinlim(_stft.inverse_log_power(spec.transpose(0, 1).contiguous(),
                                                     clip_max),
                             n_iter=n_iter, hop_length=hop_length, init_phase=phase,
                             device=dev)
        return F.pad(wav, (0, t_frames * hop_length - wav.shape[0]))
    check_options(t_frames, n, halo, rounds, axis_name)
    t_loc = t_frames // n
    r = comm.group_rank(group)
    magnitude, angles = rank_inputs(spec, phase, r, t_loc, halo, clip_max)
    n_fft = 2 * (bins - 1)
    blend = (halo - 1) * hop_length  # the longest seam a neighbour's GL covers
    k = max(1, n_iter // rounds)
    blocks = [k] * (n_iter // k)
    if sum(blocks) < n_iter:
        blocks[-1] += n_iter - sum(blocks)

    def refresh(x):
        """The halo columns of a (bins, t_ext) carry replaced by the
        neighbours' freshly iterated interior edges (zeros at the clip's
        edges)."""
        interior = x[:, halo:halo + t_loc]
        from_left, from_right = _exchange_complex(interior[:, -halo:], interior[:, :halo],
                                                  group)
        return torch.cat([from_left, interior, from_right], dim=1)

    carry = (angles, torch.zeros_like(angles))
    for i, n_block in enumerate(blocks):
        carry = tgl.gl_steps(magnitude, carry, n_block, hop_length, n_fft)
        if i < len(blocks) - 1:
            carry = (refresh(carry[0]), refresh(carry[1]))
    wav_ext = _stft.istft(magnitude * carry[0], hop_length, n_fft)
    # frame f of the extended clip centres at sample f * hop: this rank's
    # samples start at halo * hop; its rendering of the right neighbour's
    # first `blend` samples follows them
    mine = wav_ext[halo * hop_length:(halo + t_loc) * hop_length]
    tail = wav_ext[(halo + t_loc) * hop_length:(halo + t_loc) * hop_length + blend]
    neighbor_head, _ = comm.neighbor_exchange(tail, None, group)
    if r > 0:  # raised-cosine crossfade with the left neighbour's tail
        j = torch.arange(blend, dtype=mine.dtype, device=dev)
        w = 0.5 - 0.5 * torch.cos(np.pi * (j + 1) / (blend + 1))
        mine = torch.cat([w * mine[:blend] + (1.0 - w) * neighbor_head, mine[blend:]])
    return comm.all_gather_cat(mine.contiguous(), group, 0)
