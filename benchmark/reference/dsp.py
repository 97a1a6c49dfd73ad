"""Signal processing of the served path in plain PyTorch/NumPy: WAV
decoding, the log-power STFT, momentum Griffin-Lim (librosa's update), the
Slaney mel bank and the piano roll (pretty_midi's ``get_piano_roll``,
binarised, with the onset/offset matrix of the reference preprocessing).
"""
from __future__ import annotations

import wave

import numpy as np
import torch
from scipy.signal import resample_poly

TINY = 1.1754944e-38  # float32 tiny, the update's denominator guard


def read_wav(path: str, sr: int) -> np.ndarray:
    """16-bit PCM WAV -> mono float32 in [-1, 1) at ``sr`` (channels averaged,
    polyphase resampling as librosa.load)."""
    with wave.open(path, "rb") as f:
        rate, ch, width = f.getframerate(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width != 2:
        raise ValueError(f"{path}: {8 * width}-bit samples, expected 16")
    y = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    y = y.reshape(-1, ch).mean(axis=1) if ch > 1 else y
    if rate != sr:
        g = int(np.gcd(rate, sr))
        y = resample_poly(y.astype(np.float64), sr // g, rate // g).astype(np.float32)
    return np.ascontiguousarray(y, dtype=np.float32)


def read_wav_int16(path: str) -> tuple[np.ndarray, int]:
    """A mono 16-bit WAV's samples as float32 (x / 32767, the scale the
    program writes with) and its rate."""
    with wave.open(path, "rb") as f:
        if f.getsampwidth() != 2 or f.getnchannels() != 1:
            raise ValueError(f"{path}: expected mono 16-bit PCM")
        rate = f.getframerate()
        raw = f.readframes(f.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0, rate


def hann(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=device)


def stft(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centred (reflect) STFT, (..., samples) -> complex (..., bins, frames)."""
    return torch.stft(y, n_fft, hop, window=hann(n_fft, y.device), center=True,
                      pad_mode="reflect", return_complex=True)


def istft(s: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Inverse of ``stft``: hop * (frames - 1) samples, window-sum normalised."""
    return torch.istft(s, n_fft, hop, window=hann(n_fft, s.device), center=True)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's "reflect" padding of the last axis (the edge not repeated)."""
    return torch.cat([y[..., 1:pad + 1].flip(-1), y, y[..., -pad - 1:-1].flip(-1)], dim=-1)


def hann_f64(n_fft: int, device) -> torch.Tensor:
    """The periodic Hann window computed in float64, rounded to float32."""
    n = np.arange(n_fft, dtype=np.float64)
    return torch.from_numpy((0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(np.float32)
                            ).to(device)


def log_power_frames(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """log1p(|rfft(frame * window)|^2) of every whole frame of an already
    padded (..., samples): (..., frames, bins). The network's inputs pass
    through a bfloat16 cast, and the random network amplifies a flipped
    rounding there fiftyfold, so the spectrogram is taken in the order of
    operations that the served and trained paths use (frame, window, real
    FFT, re^2 + im^2, log1p) and agrees with theirs to the bit."""
    n_frames = 1 + (y.shape[-1] - n_fft) // hop
    frames = y.unfold(-1, n_fft, hop)[..., :n_frames, :]
    s = torch.fft.rfft(frames * hann_f64(n_fft, y.device), dim=-1)
    return torch.log1p(s.real ** 2 + s.imag ** 2)


def log_power_stft(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """The centred (reflect) log-power STFT, (..., samples) -> (..., frames,
    bins)."""
    return log_power_frames(reflect_pad(y, n_fft // 2), n_fft, hop)


def bucketed_log_power(audio: torch.Tensor, n_fft: int, hop: int, bucket: int
                       ) -> tuple[torch.Tensor, int]:
    """A timbre's centred log-power STFT over its frames rounded up to a
    multiple of ``bucket`` (the signal reflect-padded, then zero-padded or cut
    to that many frames' samples, as served), and its true frame count,
    1 + samples // hop; frames past it are never read."""
    n_valid = 1 + audio.shape[0] // hop
    target = (-(-n_valid // bucket) * bucket - 1) * hop + n_fft
    a = reflect_pad(audio, n_fft // 2)
    a = torch.nn.functional.pad(a, (0, target - a.shape[0])) if a.shape[0] < target else a[:target]
    return log_power_frames(a, n_fft, hop), n_valid


def griffinlim(magnitude: torch.Tensor, init_phase: torch.Tensor, n_iter: int, n_fft: int,
               hop: int, momentum: float = 0.99) -> torch.Tensor:
    """Momentum Griffin-Lim (Perraudin et al. 2013, librosa.griffinlim) of a
    (bins, frames) magnitude from ``init_phase``."""
    angles = torch.polar(torch.ones_like(magnitude), init_phase)
    rebuilt = torch.zeros_like(angles)
    mom = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        prev = rebuilt
        rebuilt = stft(istft(magnitude * angles, n_fft, hop), n_fft, hop)
        angles = rebuilt - mom * prev
        angles = angles / (angles.abs() + TINY)
    return istft(magnitude * angles, n_fft, hop)


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_bank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalised triangular mel filters, (n_mels, 1 + n_fft // 2)
    (librosa.filters.mel, htk=False, fmin 0, fmax sr / 2)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower, upper = -ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return (weights * (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]).astype(np.float32)


def piano_roll(notes, fs: int) -> tuple[np.ndarray, np.ndarray]:
    """Notes (pitch, start s, end s) -> binarised (T, 128) roll with columns
    [int(start * fs), int(end * fs)) and the onset/offset matrix (+1 where a
    pitch turns on, -1 where it turns off; frame 0 counts onsets)."""
    end = max(e for _, _, e in notes)
    length = int(np.ceil(end * fs - 1e-9))
    roll = np.zeros((length, 128), np.float32)
    for pitch, start, stop in notes:
        s, e = int(start * fs), int(stop * fs)
        if s < e and s < length:
            roll[s:min(e, length), pitch] = 1.0
    prev = np.zeros_like(roll)
    prev[1:] = roll[:-1]
    onoff = (roll > prev).astype(np.float32) - (roll < prev).astype(np.float32)
    return roll, onoff
