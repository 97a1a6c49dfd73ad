"""Inference / synthesis: user MIDI + timbre audio -> styled waveform.

Counterpart of the JAX package's ``infer/synthesize.py`` (reference
model/inference.py:22-110), serving path only:
  1. MIDI -> binarised piano roll + onset/offset roll, tiled into 860-frame
     chunks with 50 % overlap (tile count bucketed to a multiple of 4);
  2. timbre WAV -> log-power STFT on the device (host reflect pad, then a
     half-chunk sample bucket, as the JAX path does);
  3. per-tile conditioning gather (cyclic when the audio is shorter);
  4. PerformanceNet forward over all tiles in one batch;
  5. triangular crossfade blend of the overlapping tile predictions;
  6. sqrt(expm1(clip)) and 300 iterations of momentum Griffin-Lim, whose
     consistency glue is the hand-written CUDA kernel on the card.

Everything after the WAV decode stays on the device; the host sees the
waveform. The random Griffin-Lim phase comes from a ``torch.Generator``
seeded 0, so the waveform differs from the JAX package's by design.
Weights come from the experiment's best checkpoint: the port's own
``checkpoint-{epoch}.pt`` (written by ``train/loop.py``) or a reference
``.tar``. Reading msgpack/orbax checkpoints, EMA weights, the whole-clip
and time-sharded paths and the serving caches arrive in later slices.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..compat.weights import load_reference_checkpoint
from ..config import DEFAULT_DSP, DSPConfig, ModelConfig
from ..data import audio_io
from ..device import resolve_device
from ..midi import parser as midi_parser
from ..midi import pianoroll as pr
from ..models import PerformanceNet
from ..ops import griffinlim as tgl
from ..ops import stft as tstft
from ..train import checkpoint as ckpt

EMA_ITEM = "ROADMAP queue 1 item 7 (optimizer options: EMA)"


def build_model(model_cfg: ModelConfig, state_dict, device) -> PerformanceNet:
    """A PerformanceNet holding ``state_dict`` (strict keys) on ``device``,
    in eval mode, without drawing a random init first."""
    model = PerformanceNet(model_cfg, device="meta")
    state = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in state_dict.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device).eval()


def _cond_tiles(spec: torch.Tensor, starts_cond: torch.Tensor, n_valid: int,
                win: int) -> torch.Tensor:
    """Per-tile conditioning gather: tile i gets frames
    (starts_cond[i] + j) % n_valid of the (n_frames, bins) spec."""
    j = torch.arange(win, device=spec.device)
    return spec[(starts_cond[:, None] + j[None, :]) % n_valid]


def _blend(pred: torch.Tensor, starts, valid, t_total: int, l_out: int) -> torch.Tensor:
    """Triangular crossfade of overlapping tile predictions (weights
    min(j+1, win-j), normalised); frames past the MIDI's length are zero."""
    win, nb = pred.shape[1], pred.shape[2]
    j = torch.arange(win, dtype=torch.float32, device=pred.device)
    wgt = torch.minimum(j + 1.0, win - j)[:, None]
    num = torch.zeros((l_out, nb), dtype=torch.float32, device=pred.device)
    den = torch.zeros((l_out, 1), dtype=torch.float32, device=pred.device)
    for p, s, v in zip(pred, starts, valid):
        num[s : s + win] += p * wgt * v
        den[s : s + win] += wgt * v
    out = num / torch.clamp(den, min=1e-9)
    out[t_total:] = 0.0
    return out


class AudioSynthesizer:
    """Style-transfer synthesis with a PerformanceNet on ``device``."""

    def __init__(
        self,
        exp_dir: str,
        midi_source: str,
        audio_source: str,
        model_cfg: ModelConfig = ModelConfig(),
        hp: DSPConfig = DEFAULT_DSP,
        checkpoint_path: str | None = None,
        params=None,
        use_ema: bool = False,
        device: str | torch.device | None = "cuda",
    ):
        """``params``: a state_dict (torch tensors or numpy arrays, reference
        key names) to serve directly. Otherwise ``checkpoint_path`` (a port
        ``.pt`` or a reference ``.tar``), or the experiment's best
        checkpoint (``train/checkpoint.best_checkpoint``). ``device``
        defaults to the card and raises when there is none."""
        self.device = resolve_device(device)
        self.exp_dir = exp_dir
        self.hp = hp
        self.midi_source = midi_source
        self.audio_source = audio_source
        if params is None:
            if checkpoint_path is None:
                checkpoint_path, _ = ckpt.best_checkpoint(exp_dir)
            if use_ema:
                raise NotImplementedError(f"use_ema waits for {EMA_ITEM}")
            if checkpoint_path.endswith(".tar"):
                if not model_cfg.compat_mbr_noop:
                    # the reference's MBR conv weights are untrained (model.py:172)
                    print("note: reference .tar checkpoint — forcing "
                          "compat_mbr_noop=True for output parity")
                    model_cfg = dataclasses.replace(model_cfg, compat_mbr_noop=True)
                params = load_reference_checkpoint(checkpoint_path, compat_mbr_noop=True)
            else:
                # a port-trained model, MBR blocks and all, served as trained
                params = ckpt.restore_checkpoint(checkpoint_path)["params"]
        self.model_cfg = model_cfg
        self.model = build_model(model_cfg, params, self.device)

    # ---- input processing (reference inference.py:37-71) ----------------
    def _chunk_midi(self, midi_path: str, overlap: bool):
        """MIDI -> int8 tile stacks (n,860,128) x2 + tile starts + true length."""
        hp = self.hp
        mf = midi_parser.load(midi_path)
        if not mf.notes:
            raise ValueError(
                f"{midi_path} contains no notes — nothing to synthesize")
        roll, onoff = pr.vectorize_notes(mf.notes, hp.wps)
        t_total = roll.shape[0]
        win = hp.windows_per_chunk
        if t_total < win:
            roll = np.pad(roll, ((0, win - t_total), (0, 0)))
            onoff = np.pad(onoff, ((0, win - t_total), (0, 0)))
        hop = win // 2 if overlap else win
        last = max(0, roll.shape[0] - win)
        starts = list(range(0, last + 1, hop))
        if starts[-1] != last:
            starts.append(last)
        need = starts[-1] + win
        if roll.shape[0] < need:
            pad = need - roll.shape[0]
            roll = np.pad(roll, ((0, pad), (0, 0)))
            onoff = np.pad(onoff, ((0, pad), (0, 0)))
        roll_chunks = np.stack([roll[s : s + win] for s in starts]).astype(np.int8)
        onoff_chunks = np.stack([onoff[s : s + win] for s in starts]).astype(np.int8)
        self._chunk_starts = starts
        return roll_chunks, onoff_chunks, starts, t_total

    def _cond_spec_device(self, audio_path: str) -> tuple[torch.Tensor, int]:
        """Timbre audio -> (device log-power spec (bucketed frames, bins),
        TRUE frame count).

        The waveform is reflect-padded on the host (the STFT's centre
        semantics), then zero-padded/trimmed to a half-chunk frame bucket's
        sample count. Frames [0, true count) equal the unbucketed centred
        STFT; callers gather modulo the true count, so padded frames are
        never used.
        """
        hp = self.hp
        audio, _ = audio_io.read_wav(audio_path, sr=hp.sr)
        if len(audio) < hp.n_fft:
            raise ValueError(
                f"{audio_path} is shorter than one FFT window "
                f"({len(audio)} < {hp.n_fft} samples at {hp.sr} Hz) "
                "— too short to extract timbre from")
        half = hp.n_fft // 2
        a = np.pad(audio.astype(np.float32), (half, half), mode="reflect")
        n_valid = 1 + len(audio) // hp.ws  # centred-STFT frame contract
        bucket = hp.windows_per_chunk // 2
        n_bucketed = -(-n_valid // bucket) * bucket
        target = (n_bucketed - 1) * hp.ws + hp.n_fft
        a = np.pad(a, (0, target - len(a))) if len(a) < target else a[:target]
        spec = tstft.log_power_stft(torch.from_numpy(a).to(self.device),
                                    hp.n_fft, hp.ws, center=False)
        return spec.transpose(0, 1), n_valid

    def _cond_starts(self, starts, n_valid: int, cond_mode: str, win: int):
        """Cond tile offsets; the gather wraps them mod n_valid."""
        if cond_mode == "aligned":
            # each tile conditions on the audio at its own time position
            return list(starts)
        # center: one centre crop for every tile (of the cyclically tiled
        # spec when the audio is shorter than a chunk)
        if n_valid < win:
            tiled = -(-win // n_valid) * n_valid
            start = (tiled - win) // 2
        else:
            start = (n_valid - win) // 2
        return [start] * len(starts)

    def process_custom_midi_and_audio(self, midi_path: str, audio_path: str,
                                      overlap: bool = True,
                                      cond_mode: str = "aligned"):
        """Host-contract method: (N,860,128) roll/onoff and the conditioning
        ((N,860,1025) aligned, or (860,1025) center) as NumPy arrays, plus
        the MIDI's frame count. The serving path does not route through it."""
        if cond_mode not in ("aligned", "center"):
            raise ValueError(f"cond_mode must be 'aligned' or 'center', got {cond_mode!r}")
        roll_chunks, onoff_chunks, starts, t_total = self._chunk_midi(midi_path, overlap)
        win = self.hp.windows_per_chunk
        spec_dev, n_valid = self._cond_spec_device(audio_path)
        cstarts = self._cond_starts(starts, n_valid, cond_mode, win)
        if cond_mode == "center":
            cstarts = cstarts[:1]
        cond = _cond_tiles(spec_dev, torch.tensor(cstarts, device=self.device),
                           n_valid, win).cpu().numpy()
        if cond_mode == "center":
            cond = cond[0]
        return (roll_chunks.astype(np.float32), onoff_chunks.astype(np.float32),
                cond, t_total)

    # ---- synthesis ------------------------------------------------------
    @torch.inference_mode()
    def _forward_blend(self, roll, onoff, cond, starts, valid, t_total: int, l_out: int):
        pred = self.model(roll.float(), cond, onoff.float())
        return _blend(pred.float(), starts, valid, t_total, l_out)

    def _predict_device(self, midi_path: str, audio_path: str,
                        overlap: bool = True, cond_mode: str = "aligned"):
        """Device-resident predict: returns ((l_out, bins) device spec, t_total).

        Host -> device: the waveform, int8 MIDI tiles and index vectors.
        The cond spec, tile gather, forward and blend run on the device.
        """
        if cond_mode not in ("aligned", "center"):
            raise ValueError(f"cond_mode must be 'aligned' or 'center', got {cond_mode!r}")
        win = self.hp.windows_per_chunk
        roll_chunks, onoff_chunks, starts, t_total = self._chunk_midi(midi_path, overlap)
        spec_dev, n_valid = self._cond_spec_device(audio_path)
        cond_starts = self._cond_starts(starts, n_valid, cond_mode, win)

        n = roll_chunks.shape[0]
        pad_n = -(-n // 4) * 4 - n  # tile-count bucket of 4, as the JAX path

        def padn(a):
            return np.pad(a, ((0, pad_n),) + ((0, 0),) * (a.ndim - 1))

        starts = list(starts) + [0] * pad_n
        valid = [1.0] * n + [0.0] * pad_n
        l_out = max(starts) + win
        l_out = -(-l_out // (win // 2)) * (win // 2)  # output frame budget
        cond = _cond_tiles(spec_dev, torch.tensor(cond_starts + [0] * pad_n,
                                                  device=self.device), n_valid, win)
        dev = self.device
        spec = self._forward_blend(torch.from_numpy(padn(roll_chunks)).to(dev),
                                   torch.from_numpy(padn(onoff_chunks)).to(dev),
                                   cond, starts, valid, t_total, l_out)
        return spec, t_total

    def predict_spectrogram(self, roll_chunks, onoff_chunks, cond, t_total) -> np.ndarray:
        """Host-contract method (NumPy in, NumPy out): forward over all
        chunks + crossfade blend -> (t_total, 1025) log-power spec."""
        n, win = roll_chunks.shape[:2]
        pad_n = -(-n // 4) * 4 - n
        dev = self.device

        def padn(a, dtype):
            a = np.asarray(a, dtype)
            return torch.from_numpy(
                np.pad(a, ((0, pad_n),) + ((0, 0),) * (a.ndim - 1))).to(dev)

        cond = np.asarray(cond, np.float32)
        if cond.ndim == 2:  # one chunk broadcast to all tiles (center mode)
            cond_b = torch.from_numpy(cond).to(dev).expand(n + pad_n, *cond.shape)
        else:  # per-tile aligned conditioning (N, 860, 1025)
            cond_b = padn(cond, np.float32)
        starts = getattr(self, "_chunk_starts", None) or [i * win for i in range(n)]
        starts = list(starts) + [0] * pad_n
        valid = [1.0] * n + [0.0] * pad_n
        l_out = max(starts) + win
        l_out = -(-l_out // (win // 2)) * (win // 2)
        spec = self._forward_blend(padn(roll_chunks, np.int8), padn(onoff_chunks, np.int8),
                                   cond_b, starts, valid, t_total, l_out)
        return spec[:t_total].cpu().numpy()

    @torch.inference_mode()
    def _griffinlim_device(self, spec: torch.Tensor, t_total: int, n_iter: int) -> torch.Tensor:
        """(l_out, bins) predicted spec -> (t_total * ws,) device waveform.

        GL runs over the true length rounded up to half a chunk, never over
        the frames the tile bucketing padded in.
        """
        bucket = self.hp.windows_per_chunk // 2
        t_gl = min(int(spec.shape[0]), -(-t_total // bucket) * bucket)
        wav = tgl.griffinlim_from_log_power(
            spec[:t_gl].transpose(0, 1), generator=torch.Generator().manual_seed(0),
            n_iter=n_iter, hop_length=self.hp.ws,
            clip_max=self.hp.clip_log_power_max, device=self.device)
        return wav[: t_total * self.hp.ws]

    def synthesize_waveform(self, n_iter: int = 300, overlap: bool = True,
                            cond_mode: str = "aligned") -> np.ndarray:
        """Full device-resident synthesis: MIDI + audio -> waveform (host np)."""
        spec, t_total = self._predict_device(
            self.midi_source, self.audio_source, overlap=overlap, cond_mode=cond_mode)
        return self._griffinlim_device(spec, t_total, n_iter).cpu().numpy()

    def inference(self, n_iter: int = 300, output_dir: str | None = None,
                  overlap: bool = True, cond_mode: str = "aligned") -> list[str]:
        """Full path (reference inference.py:74-91): predict spec -> Griffin-Lim
        -> write output-1.wav into an auto-numbered directory."""
        print("Inferencing spectrogram......")
        wav = self.synthesize_waveform(n_iter=n_iter, overlap=overlap,
                                       cond_mode=cond_mode)
        out_dir = output_dir or self.create_output_dir()
        path = os.path.join(out_dir, "output-1.wav")
        audio_io.write_wav(path, wav, self.hp.sr)
        return [path]

    def create_output_dir(self) -> str:
        """Auto-numbered audio_output_{n} dir (reference inference.py:93-103)."""
        dir_id = 1
        while True:
            out = os.path.join(self.exp_dir, f"audio_output_{dir_id}")
            try:
                os.makedirs(out)
                return out
            except FileExistsError:
                dir_id += 1

    def griffinlim(self, spectrogram: np.ndarray, n_iter: int = 300) -> np.ndarray:
        """Log-power spec (bins, frames) -> waveform
        (reference inference.py:105-110 signature equivalent)."""
        wav = tgl.griffinlim_from_log_power(
            spectrogram, generator=torch.Generator().manual_seed(0), n_iter=n_iter,
            hop_length=self.hp.ws, clip_max=self.hp.clip_log_power_max,
            device=self.device)
        return wav.cpu().numpy()
