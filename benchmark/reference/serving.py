"""The served answer worked out plainly: score + timbre -> waveform.

The steps of the reference repository's ``model/inference.py`` as the port
serves them: the piano roll cut into 860-frame tiles at a 430-frame hop
(the last tile flush with the end), each tile conditioned on the timbre's
log-power STFT at its own frames (taken cyclically), the model's forward,
a triangular crossfade of the overlapping tiles, the inverse compression
sqrt(expm1(clip(x, 0, 20))) and 300 iterations of momentum Griffin-Lim from
the uniform phase of ``torch.Generator().manual_seed(0)`` over the score's
frames rounded up to half a tile, cut to the score's samples.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import dsp, nets


def tile_starts(t_total: int, win: int) -> list[int]:
    last = max(0, max(t_total, win) - win)
    starts = list(range(0, last + 1, win // 2))
    if starts[-1] != last:
        starts.append(last)
    return starts


def n_tiles(t_total: int, win: int) -> int:
    return len(tile_starts(t_total, win))


def waveform(params: dict, cfg: dict, notes, timbre_path: str, device, n_iter: int,
             quant=nets.identity) -> torch.Tensor:
    """The answer to one request: ``notes`` (pitch, start s, end s), the
    timbre WAV's path; float32 samples on ``device``. The tiles run as one
    batch padded to a multiple of four, as the program batches them, so the
    convolutions see the program's shapes."""
    hop, sr, n_fft, win = cfg["hop"], cfg["sr"], cfg["n_fft"], cfg["chunk_frames"]
    roll, onoff = dsp.piano_roll(notes, sr // hop)
    t_total = roll.shape[0]
    starts = tile_starts(t_total, win)
    need = starts[-1] + win
    if roll.shape[0] < need:
        pad = ((0, need - roll.shape[0]), (0, 0))
        roll, onoff = np.pad(roll, pad), np.pad(onoff, pad)
    audio = torch.from_numpy(dsp.read_wav(timbre_path, sr)).to(device)
    spec, n_valid = dsp.bucketed_log_power(audio, n_fft, hop, win // 2)
    j = torch.arange(win, device=device)
    n = len(starts)
    pad = -(-n // 4) * 4 - n  # the program's tile-count bucket: padded tiles
    rows = torch.tensor(starts + [0] * pad, device=device)[:, None] + j[None, :]
    live = torch.arange(n + pad, device=device)[:, None] < n  # padded rolls are zero
    roll_t = torch.from_numpy(roll).to(device)[rows] * live[..., None]
    onoff_t = torch.from_numpy(onoff).to(device)[rows] * live[..., None]
    with torch.no_grad():
        pred = nets.performancenet(params, cfg, roll_t, spec[rows % n_valid], onoff_t,
                                   quant=quant)[:n]
        half = win // 2
        l_out = math.ceil((starts[-1] + win) / half) * half
        wgt = torch.minimum(j + 1.0, win - j.float())[:, None]
        num = torch.zeros((l_out, pred.shape[-1]), device=device)
        den = torch.zeros((l_out, 1), device=device)
        for i, s0 in enumerate(starts):
            num[s0:s0 + win] += pred[i] * wgt
            den[s0:s0 + win] += wgt
        out = num / den.clamp(min=1e-9)
        out[t_total:] = 0.0
        n_gl = min(l_out, math.ceil(t_total / half) * half)
        mag = torch.sqrt(torch.expm1(out[:n_gl].clamp(0.0, cfg["clip_log_power_max"]))).T
        phase = 2.0 * np.pi * torch.rand(mag.shape, generator=torch.Generator().manual_seed(0))
        wav = dsp.griffinlim(mag.contiguous(), phase.to(device), n_iter, n_fft, hop,
                             cfg["gl_momentum"])
    return wav[:t_total * hop]


def gaps(served: np.ndarray, ref: torch.Tensor, n_fft: int, hop: int) -> dict[str, float]:
    """How far a served waveform (as read back from its WAV) lies from the
    reference's, which is clipped to [-1, 1] as a 16-bit WAV holds it:
    ``wave_rel_l2``, the relative L2 distance of the samples, and
    ``mag_rel_l2``, that of their STFT magnitudes."""
    r = ref.clamp(-1.0, 1.0)
    s = torch.from_numpy(np.asarray(served, np.float32)).to(r.device)
    if s.shape != r.shape:
        return {"wave_rel_l2": math.inf, "mag_rel_l2": math.inf}
    ms, mr = dsp.stft(s, n_fft, hop).abs(), dsp.stft(r, n_fft, hop).abs()
    return {"wave_rel_l2": float((s - r).norm() / r.norm().clamp(min=1e-30)),
            "mag_rel_l2": float((ms - mr).norm() / mr.norm().clamp(min=1e-30))}
