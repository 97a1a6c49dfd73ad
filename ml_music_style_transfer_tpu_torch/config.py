"""Configuration dataclasses, the port's own copy of the JAX package's
``config.py`` (``DSPConfig`` and ``ModelConfig``: same fields, defaults and
``scaled()`` rounding). ``TrainConfig`` arrives with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
    # Rematerialisation belongs to training; kept so configs compare equal.
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


DEFAULT_DSP = DSPConfig()
