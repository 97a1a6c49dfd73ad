"""The device-resident dataset: the port of the JAX package's
``data/device_store.py`` (``DeviceDataStore`` :38-160, ``gather_batch``
:163).

The whole split lives in device memory, and batches are assembled there:
  - the raw audio chunks, (S, N, 219904) as ``audio_dtype`` (bfloat16 by
    default: 8x smaller than the float32 (1025, 860) spectrograms), whose
    log-power STFTs are recomputed on the device every step;
  - the piano rolls and onset/offset matrices as int8 (values in
    {-1, 0, 1});
  - per step only three index vectors cross from the host, through pinned
    memory with non-blocking copies. The style and conditioning draws
    (reference train.py:88-91) stay on a host ``np.random.default_rng(seed)``
    and draw in the JAX store's order, so one seed gives the same
    ``(idx, cond_idx, style)`` in both packages.

Needs a file preprocessed with ``--store-audio`` (``audio_{style}`` keys),
or ``from_arrays``. MusicNet-piano scale (~1.7k chunks x 5 styles) is about
3.74 GB of bfloat16 audio and 0.37 GB of int8 rolls, beside the 732M-param
model and its Adam state.

On a mesh (``mesh=``, JAX ``data/device_store.py:41-58``) every rank
draws the same global index plan, and ``local_batch`` gives each rank its
share of the global batch:
  - ``store_sharding="replicated"`` (default): every rank holds the whole
    split and gathers its rows locally;
  - ``store_sharding="data"``: rank r of the n batch ranks holds rows
    [r * ceil(N/n), (r + 1) * ceil(N/n)) (the last padded with zeros,
    which no draw references); each step every rank contributes the rows
    it holds to one all-reduce of the batch's raw audio and rolls (the
    collectives GSPMD inserts in the JAX package), then computes the
    spectrograms of its share. The batch equals the replicated store's
    bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import DEFAULT_DSP, DSPConfig
from ..device import resolve_device
from ..ops import stft as tstft
from ..parallel import comm
from ..parallel import mesh as pmesh
from ..utils import profiling
from .hdf5_store import load_dataset


class DeviceDataStore:
    """All chunks of one split resident on ``device``; the gather and the
    STFT of each batch run there (``gather_batch``)."""

    def __init__(self, path: str, n_read: int | None = None, hp: DSPConfig = DEFAULT_DSP,
                 seed: int = 42, audio_dtype: torch.dtype = torch.bfloat16, mesh=None,
                 store_sharding: str = "replicated", device="cuda"):
        """``audio_dtype`` trades device memory for target fidelity: with
        bfloat16 audio (the default) the targets, log1p(|STFT|^2) of audio
        with an 8-bit mantissa, differ from the float32 host-streamed
        path's, so the two training modes optimize slightly different
        targets. ``torch.float32`` gives exact parity where it fits (full
        MusicNet-piano audio is ~7.5 GB in float32). ``mesh``: see the
        module docstring; the store then lies on this rank's device."""
        check_placement(store_sharding)
        raw = load_dataset(path, n_read=n_read, include_specs=False)
        self._init(raw, path, hp, seed, audio_dtype, device, mesh, store_sharding)

    @classmethod
    def from_arrays(cls, raw: Dict, hp: DSPConfig = DEFAULT_DSP, seed: int = 42,
                    audio_dtype: torch.dtype = torch.bfloat16, device="cuda",
                    source: str = "<arrays>", mesh=None,
                    store_sharding: str = "replicated") -> "DeviceDataStore":
        """A store over ``raw`` = {'pianoroll': (N,860,128), 'onoff':
        (N,860,128), 'audio_<style>': (N,219904), ...}: NumPy arrays (what
        ``load_dataset`` or ``preprocess.get_arrays`` return) or tensors,
        which may already lie on ``device``."""
        check_placement(store_sharding)
        obj = cls.__new__(cls)
        obj._init(raw, source, hp, seed, audio_dtype, device, mesh, store_sharding)
        return obj

    def _init(self, raw, source, hp, seed, audio_dtype, device, mesh=None,
              store_sharding="replicated") -> None:
        self.styles = sorted(k[len("audio_"):] for k in raw if k.startswith("audio_"))
        if not self.styles:
            raise ValueError(
                f"{source} has no audio_* keys — re-run preprocessing with --store-audio")
        self.hp = hp
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device) if mesh is None else pmesh.mesh_device(mesh)
        self._group = pmesh.batch_group(mesh)
        self._n_shards, self._shard = pmesh.batch_size(mesh), pmesh.batch_rank(mesh)
        self.store_sharding = store_sharding if self._n_shards > 1 else "replicated"
        n_roll = int(raw["pianoroll"].shape[0])
        bad = {s: int(raw[f"audio_{s}"].shape[0]) for s in self.styles
               if raw[f"audio_{s}"].shape[0] != n_roll}
        if bad:
            raise ValueError(
                f"misaligned dataset {source}: pianoroll has {n_roll} chunks but "
                f"audio styles {bad} differ (style missing for some songs)")
        self.n_data = n_roll
        n_samples = int(raw[f"audio_{self.styles[0]}"].shape[1])
        # the rows this rank holds: all, or its ceil(N/n) (zero-padded)
        lo, n_rows = 0, n_roll
        if self.store_sharding == "data":
            n_rows = -(-n_roll // self._n_shards)
            lo = self._shard * n_rows
        self.row_offset = lo
        hi = min(lo + n_rows, n_roll)

        def rows(a, dtype) -> torch.Tensor:
            out = torch.zeros((n_rows,) + tuple(a.shape[1:]), dtype=dtype, device=self.device)
            if hi > lo:
                out[:hi - lo].copy_(_as_tensor(a[lo:hi]))
            return out

        # filled style by style: at most one style's source is staged at a time
        self.audio = torch.empty((len(self.styles), n_rows, n_samples), dtype=audio_dtype,
                                 device=self.device)
        for i, s in enumerate(self.styles):
            self.audio[i].copy_(rows(raw[f"audio_{s}"], audio_dtype))
        self.pianoroll = rows(raw["pianoroll"], torch.int8)
        self.onoff = rows(raw["onoff"], torch.int8)

    def put_idx(self, arr, dtype=np.int64) -> torch.Tensor:
        """A host index vector on the device, through pinned memory."""
        return tstft.to_device(np.ascontiguousarray(arr, dtype=dtype), self.device)

    def hbm_bytes(self) -> int:
        """Bytes of the store on this rank's device."""
        return sum(x.numel() * x.element_size() for x in (self.audio, self.pianoroll, self.onoff))

    def _mine(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's share of a global per-item vector."""
        n = self._n_shards
        if n == 1:
            return v
        if v.shape[0] % n:
            raise ValueError(f"a batch of {v.shape[0]} does not split over {n} batch ranks")
        size = v.shape[0] // n
        return v[self._shard * size:(self._shard + 1) * size]

    def local_batch(self, idx, cond_idx, style, weight=None) -> Dict[str, torch.Tensor]:
        """This rank's share of the global batch at the global index
        vectors (``draw_epoch_indices``/``eval_epoch_indices``):
        ``gather_batch`` of its rows, which a data-sharded store first
        collects from the ranks that hold them. Traced, it is the span
        ``train.input`` of the step that opens next."""
        with profiling.span("train.input"):
            return self._local_batch(idx, cond_idx, style, weight)

    def _local_batch(self, idx, cond_idx, style, weight) -> Dict[str, torch.Tensor]:
        weight = None if weight is None else self._mine(weight)
        if self.store_sharding == "replicated":
            return gather_batch(self.audio, self.pianoroll, self.onoff, self._mine(idx),
                                self._mine(cond_idx), self._mine(style), self.hp, weight)
        b, n_rows = idx.shape[0], self.pianoroll.shape[0]
        rows = torch.cat([idx, cond_idx]) - self.row_offset
        styles = torch.cat([style, style])
        held = (rows >= 0) & (rows < n_rows)
        audio = torch.zeros((2 * b, self.audio.shape[-1]), dtype=torch.float32,
                            device=self.device)
        audio[held] = self.audio[styles[held], rows[held]].float()
        rolls = torch.zeros((2, b) + tuple(self.pianoroll.shape[1:]), dtype=torch.float32,
                            device=self.device)
        held_b, rows_b = held[:b], rows[:b]
        rolls[0][held_b] = self.pianoroll[rows_b[held_b]].float()
        rolls[1][held_b] = self.onoff[rows_b[held_b]].float()
        comm.all_reduce_(audio, self._group)
        comm.all_reduce_(rolls, self._group)
        return assemble_batch(self._mine(audio[:b]), self._mine(audio[b:]),
                              self._mine(rolls[0]), self._mine(rolls[1]), self.hp, weight)

    def draw_epoch_indices(self, batch_size: int, shuffle: bool = True):
        """One epoch's index plan, drawn on the host: yields (idx, cond_idx,
        style) device vectors per full batch. Traced, each batch's draw and
        uploads are the host span ``data.plan`` of the step that opens
        next."""
        order = self.rng.permutation(self.n_data) if shuffle else np.arange(self.n_data)
        n_full = self.n_data // batch_size
        for k in range(n_full):
            with profiling.span("data.plan", device=False):
                idx = order[k * batch_size:(k + 1) * batch_size]
                cond_idx = self.rng.integers(0, self.n_data, batch_size)
                style = self.rng.integers(0, len(self.styles), batch_size)
                plan = self.put_idx(idx), self.put_idx(cond_idx), self.put_idx(style)
            yield plan

    def eval_epoch_indices(self, batch_size: int):
        """Deterministic full-coverage plan for evaluation: every chunk once,
        in order; the last batch is padded with zero weights (weighted-exact
        MSE). Conditioning and style come from a fresh RNG seeded
        ``seed + 1`` on every call, so repeated evaluations measure the same
        quantity. Yields (idx, cond_idx, style, weight)."""
        rng = np.random.default_rng(self._seed + 1)
        n_batches = -(-self.n_data // batch_size)
        for k in range(n_batches):
            idx = np.arange(k * batch_size, min((k + 1) * batch_size, self.n_data))
            weight = np.ones(len(idx), np.float32)
            if len(idx) < batch_size:
                pad = batch_size - len(idx)
                idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
                weight = np.concatenate([weight, np.zeros(pad, np.float32)])
            cond_idx = rng.integers(0, self.n_data, batch_size)
            style = rng.integers(0, len(self.styles), batch_size)
            yield (self.put_idx(idx), self.put_idx(cond_idx), self.put_idx(style),
                   self.put_idx(weight, np.float32))


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def check_placement(store_sharding: str) -> None:
    if store_sharding not in ("replicated", "data"):
        raise ValueError(f"unknown store_sharding {store_sharding!r}")


def gather_batch(store_audio: torch.Tensor, store_roll: torch.Tensor, store_onoff: torch.Tensor,
                 idx: torch.Tensor, cond_idx: torch.Tensor, style: torch.Tensor,
                 hp: DSPConfig = DEFAULT_DSP, weight: torch.Tensor | None = None
                 ) -> Dict[str, torch.Tensor]:
    """Batch assembly on the store's device: the rolls at ``idx``; the
    target = log-power STFT of the style's audio at ``idx``, the cond = the
    same style's at ``cond_idx``, both upcast to float32 and taken through
    one ``log_power_stft`` of 2B chunks. Returns the channel-last batch
    dict the model consumes: midi/onoff (B, 860, 128), cond/target
    (B, 860, 1025), weight (B,)."""
    b = idx.shape[0]
    audio = store_audio[torch.cat([style, style]), torch.cat([idx, cond_idx])].float()
    return assemble_batch(audio[:b], audio[b:], store_roll[idx].float(),
                          store_onoff[idx].float(), hp, weight)


def assemble_batch(target_audio: torch.Tensor, cond_audio: torch.Tensor, roll: torch.Tensor,
                   onoff: torch.Tensor, hp: DSPConfig = DEFAULT_DSP,
                   weight: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
    """The batch dict from float32 audio rows (B, samples) and rolls: one
    ``log_power_stft`` of the 2B chunks, targets first."""
    b = target_audio.shape[0]
    spec = tstft.log_power_stft(torch.cat([target_audio, cond_audio]), hp.n_fft,
                                hp.ws).transpose(-1, -2)
    if weight is None:
        weight = torch.ones((b,), dtype=torch.float32, device=roll.device)
    return {"midi": roll, "onoff": onoff, "cond": spec[b:], "target": spec[:b],
            "weight": weight}
