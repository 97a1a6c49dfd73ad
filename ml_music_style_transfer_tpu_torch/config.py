"""Configuration dataclasses, the port's own copy of the JAX package's
``config.py`` (``DSPConfig``, ``ModelConfig`` and ``TrainConfig``: same
fields, defaults and ``scaled()`` rounding).

``PIANO_SCORES`` and ``STYLES`` are preprocessing's defaults.
``TrainConfig`` keeps every field of the JAX one so configurations compare
field by field; the options the port does not train with yet are refused
by ``unsupported_train_options`` where a ``Trainer`` is built.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class DSPConfig:
    """Signal-processing constants (reference preprocessing/preprocess.py:17-44)."""

    sr: int = 44100          # sampling rate
    n_fft: int = 2048        # FFT points
    stride: int = 512        # windows between successive chunks
    ws: int = 256            # window size: audio samples per window / STFT hop
    spc: int = 5             # seconds per chunk
    clip_log_power_max: float = 20.0  # inverse-compression clip (inference.py:109)

    @property
    def wps(self) -> int:
        """Windows (piano-roll frames) per second: 44100 // 256 = 172."""
        return self.sr // self.ws

    @property
    def n_freq_bins(self) -> int:
        """STFT bins: 1 + n_fft // 2 = 1025."""
        return 1 + self.n_fft // 2

    @property
    def windows_per_chunk(self) -> int:
        """Piano-roll windows per chunk: spc * wps = 860."""
        return self.spc * self.wps

    @property
    def samples_per_chunk(self) -> int:
        """Audio samples per chunk: (spc*wps - 1) * ws = 219,904, so a
        centered STFT with hop ``ws`` emits exactly 860 frames."""
        return (self.spc * self.wps - 1) * self.ws

    @property
    def chunk_hop_samples(self) -> int:
        """Audio samples between chunk starts: ws * stride."""
        return self.ws * self.stride


# Train/test MusicNet song-id splits and timbre styles, preprocessing's
# defaults (reference: preprocessing/preprocess.py:28-36).
PIANO_SCORES: Mapping[str, Tuple[int, ...]] = {
    "train": (
        2240, 2530, 1763, 2308, 2533, 1772, 2444, 2478,
        2509, 1776, 1749, 2486, 2487, 2678, 2490, 2492, 2527,
    ),  # 2491 is dropped in the reference (errors out; preprocess.py:32)
    "test": (2533, 1760),
}

STYLES: Tuple[str, ...] = ("cuba", "aliciakeys", "gentleman", "harpsichord", "upright")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """PerformanceNet architecture plan (reference model/model.py:177-246).

    ``width_mult`` scales every channel count (CPU tests use 1/16); the
    temporal ladder 860 -> 53 -> 860 is unchanged.
    """

    depth: int = 5
    start_channels: int = 128          # piano-roll pitch channels
    start_audio_channels: int = 1025   # STFT bins
    onset_encoder_depth: int = 3
    dropout_rate: float = 0.2          # DenseConcat dropout (training only)
    leaky_relu_slope: float = 0.01
    instance_norm_eps: float = 1e-5
    width_mult: float = 1.0
    # True reproduces the reference MBRBlock's literal 2*x (its residual add
    # is discarded, model.py:167-174); False runs the intended residual.
    compat_mbr_noop: bool = False
    # conv/linear inputs run in this dtype; params and IN statistics stay f32
    compute_dtype: str = "bfloat16"
    # Recompute each encoder DownConv in the backward pass
    # (torch.utils.checkpoint), as the JAX model's nn.remat: less activation
    # memory for about a third more encoder FLOPs. Outputs are unchanged.
    remat: bool = False

    def scaled(self, c: int) -> int:
        """Apply width_mult, rounding up to a multiple of 16 (min 16)."""
        v = max(16, int(round(c * self.width_mult)))
        return -(-v // 16) * 16

    @property
    def midi_channel_plan(self) -> Tuple[int, ...]:
        """MIDI-encoder output channels per level: 256,512,1024,2048,4096."""
        return tuple(self.scaled(self.start_channels * (2 ** (i + 1))) for i in range(self.depth))

    @property
    def audio_channel_plan(self) -> Tuple[int, ...]:
        """Audio-encoder output channels: 1536,2048,3072,4096,6144."""
        plan = (int(1024 * 1.5), 2048, int(2048 * 1.5), 4096, int(4096 * 1.5))
        return tuple(self.scaled(c) for c in plan)

    @property
    def n_out_bins(self) -> int:
        """Output spectrogram bins (lastconv out-channels = 1025)."""
        return self.start_audio_channels


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop settings (reference model/train.py:188-219)."""

    epochs: int = 1
    test_freq: int = 1
    exp_name: str = "piano_test"
    batch_size: int = 16
    learning_rate: float = 1e-3       # Adam lr (train.py:188)
    n_train_read: int | None = None
    n_test_read: int | None = None
    seed: int = 42                    # dataset and dropout RNG seed (train.py:47)
    # ReduceLROnPlateau defaults matching torch.optim.lr_scheduler (train.py:191)
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    # optional multi-scale spectral loss (train/losses.py); 0 = L1 only
    spectral_loss_weight: float = 0.0
    spectral_loss_mode: str = "linlog"  # "linlog", "log" or "direct"
    # Optimizer options of the JAX package that the port does not run yet
    # (see unsupported_train_options); the defaults are plain f32 Adam.
    adam_mu_dtype: str | None = None
    adam_nu_dtype: str | None = None
    grads_dtype: str | None = None
    grad_clip_norm: float | None = None
    warmup_steps: int = 0
    ema_decay: float | None = None
    mesh_shape: Tuple[int, int] = (1, 1)
    grad_accum: int = 1
    zero_opt: bool = False


_OPTIMIZER_ITEM = "ROADMAP queue 1 item 7 (optimizer options)"
_MULTI_DEVICE_ITEM = "ROADMAP queue 1 item 9 (multi-device)"


def unsupported_train_options(cfg: TrainConfig) -> list[str]:
    """Each option of ``cfg`` the port does not train with yet, with the
    ROADMAP item that brings it; empty when ``cfg`` is fully supported."""
    checks = (
        ("adam_mu_dtype", cfg.adam_mu_dtype is not None, _OPTIMIZER_ITEM),
        ("adam_nu_dtype", cfg.adam_nu_dtype is not None, _OPTIMIZER_ITEM),
        ("grads_dtype", cfg.grads_dtype is not None, _OPTIMIZER_ITEM),
        ("grad_clip_norm", cfg.grad_clip_norm is not None, _OPTIMIZER_ITEM),
        ("warmup_steps", cfg.warmup_steps > 0, _OPTIMIZER_ITEM),
        ("ema_decay", cfg.ema_decay is not None, _OPTIMIZER_ITEM),
        ("grad_accum", cfg.grad_accum > 1, _OPTIMIZER_ITEM),
        ("zero_opt", cfg.zero_opt, _MULTI_DEVICE_ITEM),
        ("mesh_shape", tuple(cfg.mesh_shape) != (1, 1), _MULTI_DEVICE_ITEM),
    )
    return [f"{name}={getattr(cfg, name)!r} waits for {item}"
            for name, bad, item in checks if bad]


DEFAULT_DSP = DSPConfig()
