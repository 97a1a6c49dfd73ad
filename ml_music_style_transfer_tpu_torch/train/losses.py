"""Loss functions with a per-item weight mask (the JAX package's
``train/losses.py``).

Reference contract: L1 train loss (model/train.py:132), MSE eval loss
(train.py:158), and the optional DDSP-style multi-scale spectral loss over
mel projections of the predicted and target log-power spectrograms; for
models whose output is already mel (the autoencoder family), the same
distance over band-pooled mel frames.

Every loss takes a per-item ``weight`` (B,) mask so padded eval batches
stay exact: reductions are means over the weighted items, torch's 'mean'
reduction when all weights are 1.
"""
from __future__ import annotations

import torch

from ..ops import mel as tmel


def _weighted_mean(per_item: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """per_item (B,) of per-item means -> scalar weighted mean."""
    weight = weight.to(per_item.dtype)
    return torch.sum(per_item * weight) / torch.clamp(torch.sum(weight), min=1.0)


def _item_dims(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(1, x.ndim))


def l1_loss(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """nn.L1Loss() equivalent (train.py:132)."""
    return _weighted_mean(torch.mean(torch.abs(pred - target), dim=_item_dims(pred)), weight)


def mse_loss(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """nn.MSELoss() equivalent (train.py:158)."""
    return _weighted_mean(torch.mean((pred - target) ** 2, dim=_item_dims(pred)), weight)


def multiscale_spectral_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    sr: int = 44100,
    n_fft: int = 2048,
    mel_scales: tuple = (512, 256, 128, 64),
    log_alpha: float = 1.0,
    clip_max: float = 20.0,
    mode: str = "linlog",
) -> torch.Tensor:
    """Multi-resolution spectral distance on (B, T, bins) log-power specs.

    Inverts the log1p(|.|^2) compression to power, projects it onto mel
    banks at several resolutions and, per scale, sums L1(linear) +
    log_alpha * L1(log) (Engel et al., DDSP, arXiv:2001.04643). ``mode``:
      - "linlog": L1(linear mel power) + log_alpha * L1(log mel);
      - "log": the log-mel term only;
      - "direct": no inversion; multi-scale L1 between the log1p
        spectrograms themselves, mel-banked in the log domain.

    NaN safety, as in the JAX package (losses.py:67-77): inputs are
    clipped to [0, clip_max] before inversion (expm1 of a prediction spike
    past ~88 overflows float32), and the power is expm1(x) directly, never
    sqrt(expm1(x))**2, whose sqrt'(0) = inf times a zero cotangent gives
    NaN gradients on the model's many outputs <= 0.
    """
    if mode not in ("linlog", "log", "direct"):
        raise ValueError(f"spectral loss mode must be 'linlog', 'log' or "
                         f"'direct', got {mode!r}")
    p = torch.clamp(pred, 0.0, clip_max).transpose(-1, -2)
    t = torch.clamp(target, 0.0, clip_max).transpose(-1, -2)
    if mode != "direct":
        p, t = torch.expm1(p), torch.expm1(t)
    total = 0.0
    for n_mels in mel_scales:
        mp = tmel.melspectrogram_from_power(p, sr, n_fft, n_mels)
        mt = tmel.melspectrogram_from_power(t, sr, n_fft, n_mels)
        if mode == "direct":
            per_scale = torch.mean(torch.abs(mp - mt), dim=(1, 2))
        else:
            per_scale = log_alpha * torch.mean(
                torch.abs(torch.log1p(mp) - torch.log1p(mt)), dim=(1, 2))
            if mode == "linlog":
                per_scale = torch.mean(torch.abs(mp - mt), dim=(1, 2)) + per_scale
        total = total + _weighted_mean(per_scale, weight)
    return total / len(mel_scales)


def mel_multiscale_spectral_loss(pred: torch.Tensor, target: torch.Tensor,
                                 weight: torch.Tensor, band_scales: tuple = (1, 2, 4),
                                 log_alpha: float = 1.0) -> torch.Tensor:
    """Multi-resolution spectral distance on (B, T, n_mels) log1p(mel power)
    frames (JAX ``losses.py:112-143``): for each k in ``band_scales`` the
    bands are mean-pooled k at a time to n_mels / k, and L1(linear power) +
    log_alpha * L1(log power) is accumulated; the mean over the scales.
    Raises ``ValueError`` where a scale does not divide n_mels."""
    pow_p, pow_t = torch.expm1(pred), torch.expm1(target)
    n_mels = pred.shape[-1]
    total = 0.0
    for k in band_scales:
        if n_mels % k:
            raise ValueError(f"n_mels={n_mels} not divisible by band scale {k}")
        pp = pow_p.reshape(*pow_p.shape[:-1], n_mels // k, k).mean(-1)
        pt = pow_t.reshape(*pow_t.shape[:-1], n_mels // k, k).mean(-1)
        lin = torch.mean(torch.abs(pp - pt), dim=(1, 2))
        log = torch.mean(torch.abs(torch.log1p(pp) - torch.log1p(pt)), dim=(1, 2))
        total = total + _weighted_mean(lin + log_alpha * log, weight)
    return total / len(band_scales)
