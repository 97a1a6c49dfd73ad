"""Inference / synthesis: user MIDI + timbre audio -> styled waveform.

Counterpart of the JAX package's ``infer/synthesize.py`` (reference
model/inference.py:22-110), serving path only:
  1. MIDI -> binarised piano roll + onset/offset roll, tiled into 860-frame
     chunks with 50 % overlap (tile count bucketed to a multiple of 4);
  2. timbre WAV -> log-power STFT on the device (reflect pad, then a
     half-chunk sample bucket, as the JAX path does: ``cond_spec``);
  3. per-tile conditioning gather (cyclic when the audio is shorter);
  4. PerformanceNet forward over all tiles in one batch;
  5. triangular crossfade blend of the overlapping tile predictions
     (``forward_blend``; steps 2-5 are the functions that the exported
     serving program, ``compat/program_export.py``, traces too);
  6. sqrt(expm1(clip)) and 300 iterations of momentum Griffin-Lim, whose
     consistency glue is the hand-written CUDA kernel on the card.

Everything after the WAV decode stays on the device; the host sees the
waveform. The random Griffin-Lim phase comes from a ``torch.Generator``
seeded 0, so the waveform differs from the JAX package's by design.
Weights come from the experiment's best checkpoint: the port's own
``checkpoint-{epoch}.pt`` or ``checkpoint-{epoch}.dcp`` (written by
``train/loop.py``), the JAX package's ``checkpoint-{epoch}.msgpack`` (read
without flax) or ``checkpoint-{epoch}.orbax`` (read without orbax) or a
reference ``.tar``, or from an in-memory state_dict. Of a ``.pt``,
``.dcp``, ``.msgpack`` or ``.orbax`` only the ``params`` or
``ema_params`` tree is read; the optimizer state is not. ``use_ema=True`` serves the EMA weights that a run
with ``ema_decay`` checkpointed.

A serving process keeps its warm state at module level: ``_PARAMS_CACHE``
holds the last two built, on-device, eval-mode models, so a second
synthesizer for the same checkpoint neither re-reads the file nor
re-uploads the weights. ``synthesize_waveform_async`` only queues work on
the card and returns a ``fetch()``; the daemon (``scripts/serve.py``)
overlaps the host work of one request with the card's work on the one
before. Every host<->device crossing of the serving path goes through
``_stage``/``_fetch`` (``TRANSFER_LOG`` records them). The whole-clip path
runs one forward over the whole clip (``parallel/time_shard.py``); with a
``mesh`` its time axis is sharded over the ranks of one mesh axis and
Griffin-Lim can be too (``parallel/gl_shard.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..compat.weights import from_jax_params, load_reference_checkpoint
from ..config import DEFAULT_DSP, DSPConfig, ModelConfig
from ..data import audio_io
from ..device import resolve_device
from ..midi import parser as midi_parser
from ..midi import pianoroll as pr
from ..models import PerformanceNet
from ..ops import griffinlim as tgl
from ..ops import stft as tstft
from ..parallel import comm
from ..parallel import gl_shard as glsh
from ..parallel import mesh as pmesh
from ..parallel import time_shard as tsh
from ..train import checkpoint as ckpt

# ---- transfer seams -------------------------------------------------------
# All serving host<->device crossings go through _stage/_fetch/_fetch_async.
# Tests set TRANSFER_LOG to a list to record ("h2d"|"d2h", nbytes) per
# crossing and assert that no spectrogram-sized tensor crosses.
TRANSFER_LOG: list | None = None


def _stage(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host -> device, the only upload seam of serving: through pinned
    memory and a copy that does not wait for earlier work on the card."""
    x = np.ascontiguousarray(x)
    if TRANSFER_LOG is not None:
        TRANSFER_LOG.append(("h2d", int(x.nbytes)))
    return tstft.to_device(x, device)


def _fetch(x: torch.Tensor) -> np.ndarray:
    """Device -> host, waiting for the result."""
    return _fetch_async(x)()


def _fetch_async(x: torch.Tensor) -> Callable[[], np.ndarray]:
    """Queue the device -> host copy of ``x`` now; the returned ``fetch()``
    waits for that copy only.

    There is one stream: the copy and the event after it are queued behind
    this request's work and the work of requests queued before it, never
    behind later ones. So ``fetch()`` from another thread waits for its own
    request (and those ahead of it, which a FIFO completer has already
    waited for), while the caller goes on queueing the next request.
    """
    if TRANSFER_LOG is not None:
        TRANSFER_LOG.append(("d2h", x.numel() * x.element_size()))
    if x.device.type != "cuda":
        out = x.numpy()
        return lambda: out
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(x.device))

    def fetch() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return fetch


@torch.no_grad()
def replicate_model(model: PerformanceNet, mesh, axis_name: str) -> PerformanceNet:
    """``model`` with rank 0's weights on every rank of ``mesh``'s
    ``axis_name``: broadcast once per (model, mesh) and remembered on the
    model (the JAX package replicates params once per (checkpoint, mesh),
    ``synthesize.py:493-528``)."""
    done = model.__dict__.setdefault("_replicated_on", [])
    if any(m is mesh for m in done):
        return model
    group = pmesh.axis_group(mesh, axis_name)
    if comm.group_size(group) > 1:
        src = torch.distributed.get_global_rank(group, 0)
        for t in model.state_dict().values():
            torch.distributed.broadcast(t, src, group=group)
    done.append(mesh)
    return model


# ---- module-level serving caches -------------------------------------------
# A serving process builds each model once: every AudioSynthesizer for the
# same checkpoint (or the same in-memory state_dict) shares one on-device,
# eval-mode PerformanceNet. Capped, so a long-lived daemon that outlives
# checkpoint re-saves does not pin every generation's ~2.9 GB on the card.


class _LRU:
    def __init__(self, cap: int, name: str = ""):
        self.cap = cap
        self.name = name
        self._d = collections.OrderedDict()

    def get(self, key, default=None):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return default

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            evicted, _ = self._d.popitem(last=False)
            # a refill rebuilds and re-uploads a model: make thrash visible
            logging.getLogger("mmst.serving").warning(
                "%s cache evicted %r (cap=%d); raise the cap to avoid "
                "re-upload thrash", self.name, evicted, self.cap)

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)


# key -> (source, model). Checkpoint keys are (abspath, use_ema, mtime,
# model config, device): mtime so a re-saved checkpoint is not served
# stale. In-memory keys carry id(params), and CPython reuses an id after
# garbage collection, so the source rides in the value and a hit must be
# the same object.
_PARAMS_CACHE = _LRU(2, "params")
# The daemon builds synthesizers from its reader and its completer thread:
# one lock across lookup, build and put, so two misses on one key build
# (and upload) the model once.
_PARAMS_LOCK = threading.Lock()


def clear_caches() -> None:
    """Drop the cached models (their device memory goes back once no
    synthesizer holds them)."""
    _PARAMS_CACHE.clear()


def _cached_model(key, source, build: Callable[[], PerformanceNet]) -> PerformanceNet:
    with _PARAMS_LOCK:
        entry = _PARAMS_CACHE.get(key)
        if entry is not None and entry[0] is source:
            return entry[1]
        model = build()
        _PARAMS_CACHE.put(key, (source, model))
        return model


def build_model(model_cfg: ModelConfig, state_dict, device) -> PerformanceNet:
    """A PerformanceNet holding ``state_dict`` (strict keys) on ``device``,
    in eval mode, without drawing a random init first."""
    model = PerformanceNet(model_cfg, device="meta")
    state = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in state_dict.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device).eval()


def load_checkpoint_params(path: str, use_ema: bool = False, device="cpu"
                           ) -> dict[str, torch.Tensor]:
    """The served weights of a trained checkpoint as a state_dict: its
    ``params``, or its ``ema_params`` with ``use_ema``; nothing else of the
    file is read. A ``.msgpack`` or ``.orbax`` (JAX layout) is translated
    on ``device``."""
    key = "ema_params" if use_ema else "params"
    params = ckpt.restore_checkpoint(path, keys=(key,))[key]
    if path.endswith((".msgpack", ".orbax")):
        return from_jax_params(params, device=device)
    return params


def cond_spec(audio: torch.Tensor, hp: DSPConfig = DEFAULT_DSP) -> tuple[torch.Tensor, int]:
    """Timbre waveform (samples,) on its device -> (log-power spec
    (bucketed frames, bins), TRUE frame count).

    The waveform is reflect-padded by half a window (the STFT's centre
    semantics), then zero-padded/trimmed to a half-chunk frame bucket's
    sample count. Frames [0, true count) equal the unbucketed centred
    STFT; callers gather modulo the true count, so padded frames are
    never used.
    """
    half = hp.n_fft // 2
    n_valid = 1 + audio.shape[0] // hp.ws  # centred-STFT frame contract
    bucket = hp.windows_per_chunk // 2
    n_bucketed = -(-n_valid // bucket) * bucket
    target = (n_bucketed - 1) * hp.ws + hp.n_fft
    a = tstft.reflect_pad(audio, half)
    a = F.pad(a, (0, target - a.shape[0])) if a.shape[0] < target else a[:target]
    spec = tstft.log_power_stft(a, hp.n_fft, hp.ws, center=False)
    return spec.transpose(0, 1), n_valid


def cond_tiles(spec: torch.Tensor, starts_cond: torch.Tensor, n_valid: int,
               win: int) -> torch.Tensor:
    """Per-tile conditioning gather: tile i gets frames
    (starts_cond[i] + j) % n_valid of the (n_frames, bins) spec."""
    j = torch.arange(win, device=spec.device)
    return spec[(starts_cond[:, None] + j[None, :]) % n_valid]


def _blend(pred: torch.Tensor, starts: torch.Tensor, valid: torch.Tensor, t_total,
           l_out: int) -> torch.Tensor:
    """Triangular crossfade of overlapping tile predictions (weights
    min(j+1, win-j), normalised); frames from ``t_total`` on are zero.

    ``starts`` (int64) and ``valid`` (float32) hold one entry per tile on
    ``pred``'s device, and ``t_total`` is an int or a 0-d tensor, so an
    exported program takes them as inputs. Tile i's weighted products are
    added at rows starts[i] + j, in tile order; a tile's rows are distinct,
    so each frame sums the same products in the same order wherever the
    tiles start."""
    n, win, nb = pred.shape
    dev = pred.device
    j = torch.arange(win, dtype=torch.float32, device=dev)
    wgt = torch.minimum(j + 1.0, win - j)[:, None]
    rows = torch.arange(win, device=dev)
    num = torch.zeros((l_out, nb), dtype=torch.float32, device=dev)
    den = torch.zeros((l_out, 1), dtype=torch.float32, device=dev)
    for i in range(n):
        num.index_add_(0, starts[i] + rows, pred[i] * wgt * valid[i])
        den.index_add_(0, starts[i] + rows, wgt * valid[i])
    out = num / torch.clamp(den, min=1e-9)
    return torch.where(torch.arange(l_out, device=dev)[:, None] < t_total, out, 0.0)


def forward_blend(forward: Callable, roll: torch.Tensor, onoff: torch.Tensor,
                  cond: torch.Tensor, starts: torch.Tensor, valid: torch.Tensor, t_total,
                  l_out: int) -> torch.Tensor:
    """``forward(roll, cond, onoff)`` over all tiles in one batch (int8
    rolls in, as they are uploaded), then ``_blend``: (l_out, bins)
    float32."""
    pred = forward(roll.float(), cond, onoff.float())
    return _blend(pred.float(), starts, valid, t_total, l_out)


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
        ``.pt`` or ``.dcp``, a JAX ``.msgpack`` or ``.orbax`` or a reference
        ``.tar``), or the
        experiment's best checkpoint (``train/checkpoint.best_checkpoint``).
        ``use_ema``: serve the checkpoint's ``ema_params`` (a ``ValueError``
        where it has none: the run did not set --ema-decay). The built model
        comes from ``_PARAMS_CACHE`` when the same checkpoint (unchanged
        mtime) or the same ``params`` object was served before; a reference
        ``.tar`` forces ``compat_mbr_noop=True`` and ``self.model_cfg`` is
        the config the model was built with. ``device`` defaults to the card
        and raises when there is none."""
        self.device = resolve_device(device)
        self.exp_dir = exp_dir
        self.hp = hp
        self.midi_source = midi_source
        self.audio_source = audio_source
        dev = self.device
        if params is not None:
            key = ("inmem", id(params), model_cfg, str(dev))
            self.model = _cached_model(key, params,
                                       lambda: build_model(model_cfg, params, dev))
        else:
            if checkpoint_path is None:
                checkpoint_path, _ = ckpt.best_checkpoint(exp_dir)
            path = checkpoint_path
            is_tar = path.endswith(".tar")
            if is_tar and use_ema:
                raise ValueError("reference .tar checkpoints carry no EMA weights")
            if is_tar and not model_cfg.compat_mbr_noop:
                # the reference's MBR conv weights are untrained (model.py:172)
                print("note: reference .tar checkpoint — forcing "
                      "compat_mbr_noop=True for output parity")
                model_cfg = dataclasses.replace(model_cfg, compat_mbr_noop=True)
            cfg = model_cfg

            def build() -> PerformanceNet:
                if is_tar:
                    state = load_reference_checkpoint(path, compat_mbr_noop=True)
                else:  # a trained model, MBR blocks and all, served as trained
                    state = load_checkpoint_params(path, use_ema, dev)
                return build_model(cfg, state, dev)

            key = (os.path.abspath(path), use_ema, os.path.getmtime(path), cfg, str(dev))
            self.model = _cached_model(key, None, build)
        self.model_cfg = self.model.cfg

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
        """Timbre audio file -> (device log-power spec (bucketed frames,
        bins), TRUE frame count): the waveform is uploaded and ``cond_spec``
        runs on the device."""
        hp = self.hp
        audio, _ = audio_io.read_wav(audio_path, sr=hp.sr)
        if len(audio) < hp.n_fft:
            raise ValueError(
                f"{audio_path} is shorter than one FFT window "
                f"({len(audio)} < {hp.n_fft} samples at {hp.sr} Hz) "
                "— too short to extract timbre from")
        return cond_spec(_stage(audio.astype(np.float32), self.device), hp)

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
        cond = _fetch(cond_tiles(spec_dev, _stage(np.asarray(cstarts, np.int64), self.device),
                                 n_valid, win))
        if cond_mode == "center":
            cond = cond[0]
        return (roll_chunks.astype(np.float32), onoff_chunks.astype(np.float32),
                cond, t_total)

    # ---- synthesis ------------------------------------------------------
    @torch.inference_mode()
    def _forward_blend(self, roll, onoff, cond, starts, valid, t_total: int, l_out: int):
        return forward_blend(self.model, roll, onoff, cond, starts, valid, t_total, l_out)

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
        dev = self.device
        idx = _stage(np.asarray([starts, cond_starts + [0] * pad_n], np.int64), dev)
        cond = cond_tiles(spec_dev, idx[1], n_valid, win)
        spec = self._forward_blend(_stage(padn(roll_chunks), dev), _stage(padn(onoff_chunks), dev),
                                   cond, idx[0], _stage(np.asarray(valid, np.float32), dev),
                                   t_total, l_out)
        return spec, t_total

    def predict_spectrogram(self, roll_chunks, onoff_chunks, cond, t_total) -> np.ndarray:
        """Host-contract method (NumPy in, NumPy out): forward over all
        chunks + crossfade blend -> (t_total, 1025) log-power spec."""
        n, win = roll_chunks.shape[:2]
        pad_n = -(-n // 4) * 4 - n
        dev = self.device

        def padn(a, dtype):
            a = np.asarray(a, dtype)
            return _stage(np.pad(a, ((0, pad_n),) + ((0, 0),) * (a.ndim - 1)), dev)

        cond = np.asarray(cond, np.float32)
        if cond.ndim == 2:  # one chunk broadcast to all tiles (center mode)
            cond_b = _stage(cond, dev).expand(n + pad_n, *cond.shape)
        else:  # per-tile aligned conditioning (N, 860, 1025)
            cond_b = padn(cond, np.float32)
        starts = getattr(self, "_chunk_starts", None) or [i * win for i in range(n)]
        starts = list(starts) + [0] * pad_n
        valid = [1.0] * n + [0.0] * pad_n
        l_out = max(starts) + win
        l_out = -(-l_out // (win // 2)) * (win // 2)
        spec = self._forward_blend(padn(roll_chunks, np.int8), padn(onoff_chunks, np.int8),
                                   cond_b, _stage(np.asarray(starts, np.int64), dev),
                                   _stage(np.asarray(valid, np.float32), dev), t_total, l_out)
        return _fetch(spec[:t_total])

    @torch.inference_mode()
    def _gl_waveform(self, spec: torch.Tensor, n_iter: int, seed: int = 0) -> torch.Tensor:
        """(frames, bins) log-power spec -> device waveform: Griffin-Lim
        with the phase of ``torch.Generator().manual_seed(seed)``. The
        (bins, frames) input is made contiguous, the layout a row of
        ``bulk.bulk_griffinlim``'s batch has, so both give the same bits."""
        return tgl.griffinlim_from_log_power(
            spec.transpose(0, 1).contiguous(), generator=torch.Generator().manual_seed(seed),
            n_iter=n_iter, hop_length=self.hp.ws,
            clip_max=self.hp.clip_log_power_max, device=self.device)

    def gl_frames(self, spec: torch.Tensor, t_total: int) -> int:
        """Griffin-Lim's frame count: the true length rounded up to half a
        chunk, never the frames the tile bucketing padded in."""
        bucket = self.hp.windows_per_chunk // 2
        return min(int(spec.shape[0]), -(-t_total // bucket) * bucket)

    def _griffinlim_device(self, spec: torch.Tensor, t_total: int, n_iter: int,
                           seed: int = 0) -> torch.Tensor:
        """(l_out, bins) predicted spec -> (t_total * ws,) device waveform."""
        wav = self._gl_waveform(spec[: self.gl_frames(spec, t_total)], n_iter, seed)
        return wav[: t_total * self.hp.ws]

    # ---- whole-clip one-pass path ---------------------------------------
    def _whole_clip_rolls(self, midi_path: str):
        mf = midi_parser.load(midi_path)
        if not mf.notes:
            raise ValueError(f"{midi_path} contains no notes — nothing to synthesize")
        return pr.vectorize_notes(mf.notes, self.hp.wps)

    def process_whole_clip(self, midi_path: str, audio_path: str):
        """Unchunked host-contract inputs for the one-pass forward: roll and
        onoff (T, 128) and the centred cond spec (T, 1025) cyclically
        extended or cut to the MIDI's frame count (the reference forwards
        whole clips and needs both branches' lengths to agree,
        model/inference.py:82-84)."""
        hp = self.hp
        roll, onoff = self._whole_clip_rolls(midi_path)
        t_total = roll.shape[0]
        audio, _ = audio_io.read_wav(audio_path, sr=hp.sr)
        spec = _fetch(tstft.log_power_stft(_stage(audio.astype(np.float32), self.device),
                                           hp.n_fft, hp.ws)).T
        if spec.shape[0] < t_total:
            spec = np.tile(spec, (-(-t_total // spec.shape[0]), 1))
        return (roll.astype(np.float32), onoff.astype(np.float32),
                np.ascontiguousarray(spec[:t_total], np.float32), t_total)

    def predict_spectrogram_whole_clip(self, roll, onoff, cond_spec, t_total,
                                       mesh=None, axis_name: str = "time") -> np.ndarray:
        """One forward over the entire clip, the reference's inference
        semantics (model/inference.py:82-84: no tiling, InstanceNorm
        statistics spanning the clip); host arrays in, (t_out, bins) out,
        t_out from the net's temporal ladder
        (``time_shard.time_sharded_output_length``). With ``mesh`` the
        time axis is sharded over its ``axis_name`` (every rank calls this
        together and gets the whole result)."""
        dev = self.device
        if mesh is None:
            def up(a):
                return _stage(np.asarray(a, np.float32)[None, :t_total], dev)

            out = tsh.whole_clip_forward(self.model, up(roll), up(cond_spec), up(onoff))
            return _fetch(out[0])
        fn, t_pad, t_out = self._ts_forward(t_total, mesh, axis_name)

        def up_local(a):
            p = np.zeros((1, t_pad, a.shape[-1]), np.float32)
            p[0, :t_total] = np.asarray(a, np.float32)[:t_total]
            return tsh.shard_time(_stage(p, dev), mesh, axis_name)

        with torch.inference_mode():
            out = fn(up_local(roll), up_local(cond_spec), up_local(onoff))
            full = comm.all_gather_cat(out[0], pmesh.axis_group(mesh, axis_name), 0)
        return _fetch(full[:t_out])

    def _ts_forward(self, t_total: int, mesh, axis_name: str):
        """(fn, t_pad, t_out) of the time-sharded forward over ``mesh``'s
        ``axis_name``, on this synthesizer's model replicated from the
        axis's rank 0."""
        replicate_model(self.model, mesh, axis_name)
        return tsh.make_time_sharded_forward(self.model, mesh, t_total, axis_name)

    def _predict_whole_clip_device(self) -> tuple[torch.Tensor, int]:
        """Device-resident one-pass forward: returns the (t_gl, bins) device
        spec (t_out frames, zero log-power up to t_gl, t_out rounded up to
        half a chunk) and t_out.

        Uploads the waveform and the int8 rolls; the cond spec is the
        bucketed device STFT gathered cyclically to the MIDI's frame count
        on the card."""
        hp, dev = self.hp, self.device
        roll, onoff = self._whole_clip_rolls(self.midi_source)
        t_total = roll.shape[0]
        spec_dev, n_valid = self._cond_spec_device(self.audio_source)
        cond = spec_dev[torch.arange(t_total, device=dev) % n_valid]
        out = tsh.whole_clip_forward(self.model, _stage(roll[None].astype(np.int8), dev),
                                     cond[None], _stage(onoff[None].astype(np.int8), dev))
        t_out = out.shape[1]
        bucket = hp.windows_per_chunk // 2
        t_gl = -(-t_out // bucket) * bucket
        return F.pad(out[0], (0, 0, 0, t_gl - t_out)), t_out

    def prepare_whole_clip(self, mesh, axis_name: str = "time", shard_gl: bool | None = None,
                           gl_halo: int = 32, gl_rounds: int = 10) -> dict:
        """The part of ``synthesize_whole_clip`` over ``mesh`` that waits on
        no other rank: reads the MIDI and the audio, puts the cond spec and
        this rank's slices of the int8 rolls on the device, resolves
        ``shard_gl`` and checks the Griffin-Lim options (raising
        ``parallel/gl_shard.py``'s ``ValueError``s here, before any
        collective). A server whose ranks must agree that a request can run
        calls it on each and hands the result to ``synthesize_whole_clip``
        (``scripts/serve.py``)."""
        hp, dev = self.hp, self.device
        roll, onoff = self._whole_clip_rolls(self.midi_source)
        t_total = roll.shape[0]
        n = pmesh.axis_size(mesh, axis_name)
        t_pad = tsh.padded_length(t_total, n, self.model.cfg.depth)
        if shard_gl is None:
            shard_gl = n > 1 and t_pad // n > gl_halo
        if shard_gl and n > 1:
            glsh.check_options(t_pad, n, gl_halo, gl_rounds, axis_name)
        spec_dev, n_valid = self._cond_spec_device(self.audio_source)
        cond = spec_dev[torch.arange(t_pad, device=dev) % n_valid]
        cond = torch.where(torch.arange(t_pad, device=dev)[:, None] < t_total, cond, 0.0)

        def rolls_local(a):
            p = np.zeros((1, t_pad, a.shape[-1]), np.int8)
            p[0, :t_total] = a
            return tsh.shard_time(_stage(p, dev), mesh, axis_name)

        return {"mesh": mesh, "axis_name": axis_name, "t_total": t_total, "shard_gl": shard_gl,
                "gl_halo": gl_halo, "gl_rounds": gl_rounds, "roll": rolls_local(roll),
                "onoff": rolls_local(onoff), "cond": tsh.shard_time(cond[None], mesh, axis_name)}

    def _predict_whole_clip_sharded(self, prep: dict):
        """The time-sharded one-pass forward of a ``prepare_whole_clip``
        result: returns the whole (t_pad, bins) device spec on every rank
        (zero past t_out), t_pad and t_out."""
        mesh, axis_name = prep["mesh"], prep["axis_name"]
        fn, t_pad, t_out = self._ts_forward(prep["t_total"], mesh, axis_name)
        with torch.inference_mode():
            out = fn(prep["roll"].float(), prep["cond"], prep["onoff"].float())
            full = comm.all_gather_cat(out[0], pmesh.axis_group(mesh, axis_name), 0)
        return full, t_pad, t_out

    def synthesize_whole_clip(self, n_iter: int = 300, mesh=None, axis_name: str = "time",
                              shard_gl: bool | None = None, gl_halo: int = 32,
                              gl_rounds: int = 10, prepared: dict | None = None) -> np.ndarray:
        """Device-resident whole-clip serving: one forward over the whole
        clip, then Griffin-Lim over its t_out frames rounded up to half a
        chunk (zero log-power past t_out), cut to t_out * ws samples; only
        the waveform comes back.

        ``mesh``: shard the forward's time axis over its ``axis_name``
        (every rank of the axis calls this together; each gets the
        waveform). ``shard_gl``: run Griffin-Lim time-sharded too
        (``parallel/gl_shard.py``, ``gl_halo`` frames of context and
        ``gl_rounds`` Schwarz rounds); None (the JAX rule) turns it on where
        the axis has more than one rank and each rank's share of the
        padded clip exceeds the halo; False gathers the prediction and runs
        one device's Griffin-Lim on every rank. On one rank both give the
        same waveform. With no mesh ``shard_gl`` changes nothing (one
        device). ``prepared``: this rank's ``prepare_whole_clip`` result,
        which then stands for ``mesh`` and the options."""
        hp = self.hp
        if mesh is None and prepared is None:
            spec, t_out = self._predict_whole_clip_device()
            wav = self._gl_waveform(spec, n_iter)
            return _fetch(wav[: t_out * hp.ws])
        prep = prepared or self.prepare_whole_clip(mesh, axis_name, shard_gl, gl_halo, gl_rounds)
        mesh, axis_name = prep["mesh"], prep["axis_name"]
        full, t_pad, t_out = self._predict_whole_clip_sharded(prep)
        n = pmesh.axis_size(mesh, axis_name)
        bucket = hp.windows_per_chunk // 2
        t_gl = -(-t_out // bucket) * bucket
        spec_gl = F.pad(full[:t_out], (0, 0, 0, t_gl - t_out))
        if prep["shard_gl"]:
            # the padded clip's frames divide the axis; on one rank the
            # gathered path's frames, so the waveform is the same
            wav = glsh.sharded_griffinlim_from_log_power(
                full if n > 1 else spec_gl, mesh, axis_name=axis_name, n_iter=n_iter,
                hop_length=hp.ws, clip_max=hp.clip_log_power_max, halo=prep["gl_halo"],
                seed=0, rounds=prep["gl_rounds"])
        else:
            wav = self._gl_waveform(spec_gl, n_iter)
        return _fetch(wav[: t_out * hp.ws])

    # ---- serving ----------------------------------------------------------
    def synthesize_waveform_async(self, n_iter: int = 300, overlap: bool = True,
                                  cond_mode: str = "aligned",
                                  seed: int = 0) -> Callable[[], np.ndarray]:
        """Queue the full device-resident synthesis without waiting for it.

        The host work (MIDI parse, WAV decode, uploads through pinned
        memory) runs here; the cond STFT, tile gather, forward, blend,
        Griffin-Lim and the waveform's copy to pinned host memory are only
        queued on the card. Returns a zero-argument ``fetch()`` that waits
        for this request's waveform (see ``_fetch_async``). ``seed`` picks
        Griffin-Lim's phase (``torch.Generator().manual_seed(seed)``). On
        the CPU the work is done before this returns.

        Nothing here synchronises with the card, but a request is about
        4,700 kernel launches and the card holds about 1,000 pending ones
        (chip_smoke.py measures both): past that, a launch waits for a
        slot, so the host runs at most that far ahead of the card.
        """
        spec, t_total = self._predict_device(
            self.midi_source, self.audio_source, overlap=overlap, cond_mode=cond_mode)
        return _fetch_async(self._griffinlim_device(spec, t_total, n_iter, seed))

    def synthesize_waveform(self, n_iter: int = 300, overlap: bool = True,
                            cond_mode: str = "aligned") -> np.ndarray:
        """Full device-resident synthesis: MIDI + audio -> waveform (host np).
        Uploads: the timbre waveform and int8 MIDI tiles; download: the
        synthesized waveform; no spectrogram crosses."""
        return self.synthesize_waveform_async(
            n_iter=n_iter, overlap=overlap, cond_mode=cond_mode)()

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
        with torch.inference_mode():
            wav = tgl.griffinlim_from_log_power(
                spectrogram, generator=torch.Generator().manual_seed(0), n_iter=n_iter,
                hop_length=self.hp.ws, clip_max=self.hp.clip_log_power_max,
                device=self.device)
        return _fetch(wav)
