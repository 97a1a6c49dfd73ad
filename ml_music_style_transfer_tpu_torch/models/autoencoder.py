"""Compact conv spectrogram autoencoder: the small model family (the JAX
package's ``models/autoencoder.py``).

A fast-iterating stand-in for PerformanceNet when prototyping losses and
DSP, built from the same blocks (``models/layers.py``) with the same public
layout, channel-last (B, T, bins): three DownConvs (pooling on the first
two), two torch-semantics ConvTransposes (k 4, s 2, p 1: an exact 2x
upsample) each with InstanceNorm + LeakyReLU, and a Conv1x3 head with ReLU.
T must be divisible by 4. Inside, the shapes are channel-first (B, C, T);
in a training forward on the card the memory is channel-last, as in
PerformanceNet: the input is cast to the compute dtype as a contiguous
(B, T, bins) tensor and viewed as (B, bins, T) (``layers.model_input``),
so cuDNN runs every convolution and its gradients in NHWC with no
transpose; the head's output returns channel-first and leaves as its
(B, T, bins) view. The modules carry the flax module names
(``down_0``, ``down_1``, ``bottleneck``, ``up_0``, ``up_1``, ``head``), so
``compat/weights.from_jax_params(tree, AUTOENCODER)`` loads a flax tree.

``make_autoencoder_train_step`` is the family's training contract: raw
log-power STFT frames (B, T, 1 + n_fft // 2) go in; on the device they are
projected to ``n_bins`` mel bands (``mel_encode``); the model reconstructs
the mel frames under ``mel_multiscale_spectral_loss``, with fused Adam.
The family runs no hand-written kernel: the JAX autoencoder reaches no
Pallas kernel either.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import mel as tmel
from ..utils import profiling
from .layers import (Conv1x3, ConvTranspose1dTorch, DownConv, _dtype, instance_norm,
                     leaky_relu, model_input, to_channel_first)


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    n_bins: int = 1025          # input/output spectrogram bins (or n_mels)
    width: int = 256            # base channel count
    compute_dtype: str = "bfloat16"


class SpectrogramAutoencoder(nn.Module):
    """(B, T, bins) -> (B, T, bins) float32. Weights xavier-normal and
    biases zero from ``generator`` (default: seeded 0 on the device)."""

    def __init__(self, cfg: AutoencoderConfig = AutoencoderConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        with profiling.setup_span("setup.model"):
            self.cfg = cfg
            w, dt = cfg.width, cfg.compute_dtype
            self.down_0 = DownConv(cfg.n_bins, w, True, dt, device=device)
            self.down_1 = DownConv(w, 2 * w, True, dt, device=device)
            self.bottleneck = DownConv(2 * w, 4 * w, False, dt, device=device)
            self.up_0 = ConvTranspose1dTorch(4 * w, 2 * w, 4, 2, 1, dt, device)
            self.up_1 = ConvTranspose1dTorch(2 * w, w, 4, 2, 1, dt, device)
            self.head = Conv1x3(w, cfg.n_bins, dt, device)
            first = next(self.parameters())
            if first.device.type == "meta":
                return
            gen = generator or torch.Generator(device=first.device).manual_seed(0)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    if name.endswith(".bias"):
                        p.zero_()
                    else:
                        nn.init.xavier_normal_(p, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, _ = self.down_0(model_input(x, _dtype(self.cfg.compute_dtype)))
        h, _ = self.down_1(h)
        h, _ = self.bottleneck(h)
        h = leaky_relu(instance_norm(self.up_0(h)))
        h = leaky_relu(instance_norm(self.up_1(h)))
        return F.relu(to_channel_first(self.head(h))).float().transpose(1, 2)


class AutoencoderTrainer(NamedTuple):
    """Handles from ``make_autoencoder_train_step``."""
    step: Callable        # (spec_log_power, weight) -> loss (device scalar)
    optimizer: torch.optim.Adam
    mel_encode: Callable  # (B, T, 1 + n_fft // 2) log power -> (B, T, n_bins) log1p mel
    loss_fn: Callable     # (mel, weight) -> scalar spectral loss


def make_autoencoder_train_step(model: SpectrogramAutoencoder, sr: int = 44100,
                                n_fft: int = 2048, learning_rate: float = 1e-3,
                                band_scales: tuple = (1, 2, 4)) -> AutoencoderTrainer:
    """The spectral-loss train step on mel frames (JAX
    ``autoencoder.py:59-107``) for ``model``, which it updates in place with
    Adam (fused on the card). ``mel_encode`` inverts the log compression,
    projects the power onto ``model.cfg.n_bins`` mel bands (one matmul) and
    re-compresses with log1p; ``loss_fn`` is the multi-scale mel spectral
    distance between the reconstruction and the mel target at band
    resolutions n_bins / k, k in ``band_scales``. Traced, ``step`` is the
    span ``train.step`` around ``train.input`` (``mel_encode``),
    ``train.forward``, ``train.loss``, ``train.backward`` and
    ``train.optimizer``, as ``Trainer.train_step``'s; building the
    optimizer is part of the set-up span ``setup.model``."""
    from ..train import losses  # train/ imports the models: not at import time

    n_bins = model.cfg.n_bins
    params = list(model.parameters())
    with profiling.setup_span("setup.model"):
        optimizer = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                     fused=True if params[0].device.type == "cuda" else None)

    @torch.no_grad()
    def mel_encode(spec_log_power: torch.Tensor) -> torch.Tensor:
        fb = tmel.mel_filterbank(sr, n_fft, n_bins, device=spec_log_power.device)
        power = torch.expm1(spec_log_power.float())  # invert ops/stft's log1p(|.|^2)
        return torch.log1p(torch.matmul(power, fb.t()))

    def loss_fn(mel: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        with profiling.span("train.forward"):
            pred = model(mel)
        with profiling.span("train.loss"):
            return losses.mel_multiscale_spectral_loss(pred, mel, weight,
                                                       band_scales=band_scales)

    def step(spec_log_power: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        with profiling.span("train.step", step=True):
            optimizer.zero_grad(set_to_none=True)
            with profiling.span("train.input"):
                mel = mel_encode(spec_log_power)
            loss = loss_fn(mel, weight)
            with profiling.span("train.backward"):
                loss.backward()
            with profiling.span("train.optimizer"):
                optimizer.step()
            return loss.detach()

    return AutoencoderTrainer(step=step, optimizer=optimizer, mel_encode=mel_encode,
                              loss_fn=loss_fn)
