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
model and its Adam state. One card only: ``mesh`` and
``store_sharding="data"`` raise.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import DEFAULT_DSP, DSPConfig
from ..device import resolve_device
from ..ops import stft as tstft
from .hdf5_store import load_dataset

MULTI_DEVICE_ITEM = "ROADMAP queue 1 item 9 (multi-device)"


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
        MusicNet-piano audio is ~7.5 GB in float32)."""
        check_placement(mesh, store_sharding)
        raw = load_dataset(path, n_read=n_read, include_specs=False)
        self._init(raw, path, hp, seed, audio_dtype, device)

    @classmethod
    def from_arrays(cls, raw: Dict, hp: DSPConfig = DEFAULT_DSP, seed: int = 42,
                    audio_dtype: torch.dtype = torch.bfloat16, device="cuda",
                    source: str = "<arrays>") -> "DeviceDataStore":
        """A store over ``raw`` = {'pianoroll': (N,860,128), 'onoff':
        (N,860,128), 'audio_<style>': (N,219904), ...}: NumPy arrays (what
        ``load_dataset`` or ``preprocess.get_arrays`` return) or tensors,
        which may already lie on ``device``."""
        obj = cls.__new__(cls)
        obj._init(raw, source, hp, seed, audio_dtype, device)
        return obj

    def _init(self, raw, source, hp, seed, audio_dtype, device) -> None:
        self.styles = sorted(k[len("audio_"):] for k in raw if k.startswith("audio_"))
        if not self.styles:
            raise ValueError(
                f"{source} has no audio_* keys — re-run preprocessing with --store-audio")
        self.hp = hp
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        n_roll = int(raw["pianoroll"].shape[0])
        bad = {s: int(raw[f"audio_{s}"].shape[0]) for s in self.styles
               if raw[f"audio_{s}"].shape[0] != n_roll}
        if bad:
            raise ValueError(
                f"misaligned dataset {source}: pianoroll has {n_roll} chunks but "
                f"audio styles {bad} differ (style missing for some songs)")
        self.n_data = n_roll
        n_samples = int(raw[f"audio_{self.styles[0]}"].shape[1])
        # filled style by style: at most one style's source is staged at a time
        self.audio = torch.empty((len(self.styles), n_roll, n_samples), dtype=audio_dtype,
                                 device=self.device)
        for i, s in enumerate(self.styles):
            self.audio[i].copy_(_as_tensor(raw[f"audio_{s}"]))
        self.pianoroll = _as_tensor(raw["pianoroll"]).to(self.device, torch.int8)
        self.onoff = _as_tensor(raw["onoff"]).to(self.device, torch.int8)

    def put_idx(self, arr, dtype=np.int64) -> torch.Tensor:
        """A host index vector on the device, through pinned memory."""
        return tstft.to_device(np.ascontiguousarray(arr, dtype=dtype), self.device)

    def hbm_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in (self.audio, self.pianoroll, self.onoff))

    def draw_epoch_indices(self, batch_size: int, shuffle: bool = True):
        """One epoch's index plan, drawn on the host: yields (idx, cond_idx,
        style) device vectors per full batch."""
        order = self.rng.permutation(self.n_data) if shuffle else np.arange(self.n_data)
        n_full = self.n_data // batch_size
        for k in range(n_full):
            idx = order[k * batch_size:(k + 1) * batch_size]
            cond_idx = self.rng.integers(0, self.n_data, batch_size)
            style = self.rng.integers(0, len(self.styles), batch_size)
            yield self.put_idx(idx), self.put_idx(cond_idx), self.put_idx(style)

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


def check_placement(mesh, store_sharding: str) -> None:
    """Raise for a placement other than one card's (a mesh waits for item 9)."""
    if store_sharding not in ("replicated", "data"):
        raise ValueError(f"unknown store_sharding {store_sharding!r}")
    if mesh is not None or store_sharding != "replicated":
        raise NotImplementedError(
            f"a store on a mesh (mesh={mesh!r}, store_sharding={store_sharding!r}) "
            f"waits for {MULTI_DEVICE_ITEM}")


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
    spec = tstft.log_power_stft(audio, hp.n_fft, hp.ws).transpose(-1, -2)
    if weight is None:
        weight = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    return {"midi": store_roll[idx].float(), "onoff": store_onoff[idx].float(),
            "cond": spec[b:], "target": spec[:b], "weight": weight}
