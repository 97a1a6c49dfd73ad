"""Bulk (multi-clip) synthesis on one device.

Counterpart of the JAX package's ``infer/bulk.py``, single-device part. The
JAX package inverts a batch of clips with one ``lax.map`` dispatch and
shards the batch over a mesh's data axes; here the clips run one after
another through the same path as a single request (so each clip launches
the K3 glue kernels ``n_iter`` times): on one card a stacked batch saves
nothing. Phase seeds are explicit and per clip: clip i's phase is drawn
from ``torch.Generator().manual_seed(seeds[i])`` exactly as a single
request draws seed 0, so a batch reproduces single-request synthesis bit
for bit on one device. Sharding over a mesh waits for ROADMAP queue 1
item 9.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_DSP, DSPConfig, ModelConfig
from ..device import resolve_device
from ..ops import griffinlim as tgl
from . import synthesize as S


@torch.inference_mode()
def bulk_griffinlim(specs, seeds, mesh=None, n_iter: int = 300, hop_length: int = 256,
                    clip_max: float = 20.0, device: str | torch.device | None = "cuda"):
    """(N, bins, frames) log-power specs -> (N, samples) waveforms on
    ``device``. ``seeds``: N per-clip phase seeds. ``mesh`` must be None.

    A 3-D batch is not handed to ``griffinlim`` with one generator: that
    would draw the clips' phases one after another from it, and clip i
    would not equal its single-request result.
    """
    S._single_device(mesh)
    dev = resolve_device(device)
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    if len(seeds) != len(specs):
        raise ValueError(f"{len(seeds)} seeds for {len(specs)} clips")
    return torch.stack([
        tgl.griffinlim_from_log_power(
            spec, generator=torch.Generator().manual_seed(seed), n_iter=n_iter,
            hop_length=hop_length, clip_max=clip_max, device=dev)
        for spec, seed in zip(specs, seeds)])


def batch_synthesize_waveforms(synths, n_iter: int = 300, overlap: bool = True,
                               cond_mode: str = "aligned", mesh=None, seeds=None):
    """Dynamic batching for the serving daemon: N requests, each through
    ``synthesize_waveform_async``, all queued before the first is fetched
    (so the host prepares item i+1 while the card runs item i).

    ``seeds``: optional per-request phase seeds, default 0 (=
    ``synthesize_waveform``). Returns ``(wavs, errors)``, both length N: a
    request that fails, on the host or on the card, gets an error string
    and a None waveform and does not fail the rest.
    """
    S._single_device(mesh)
    n = len(synths)
    fetches: list = [None] * n
    wavs: list = [None] * n
    errors: list = [None] * n
    for i, s in enumerate(synths):
        try:
            fetches[i] = s.synthesize_waveform_async(
                n_iter=n_iter, overlap=overlap, cond_mode=cond_mode,
                seed=0 if seeds is None else int(seeds[i]))
        except Exception as e:  # noqa: BLE001 — per-request isolation
            errors[i] = f"{type(e).__name__}: {e}"
    for i, fetch in enumerate(fetches):
        if fetch is None:
            continue
        try:
            wavs[i] = fetch()
        except Exception as e:  # noqa: BLE001 — per-request isolation
            errors[i] = f"{type(e).__name__}: {e}"
    return wavs, errors


def bulk_synthesize(model_cfg: ModelConfig, params, roll, onoff, cond, mesh=None,
                    n_iter: int = 300, hp: DSPConfig = DEFAULT_DSP,
                    device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Forward + Griffin-Lim for a batch of single-chunk clips.

    ``params``: a state_dict (built once through the serving cache);
    ``roll``/``onoff``: (N, 860, 128); ``cond``: (N, 860, 1025). Returns the
    (N, samples) waveforms on ``device``, clip i with phase seed i.
    """
    S._single_device(mesh)
    dev = resolve_device(device)
    model = S._cached_model(("inmem", id(params), model_cfg, str(dev)), params,
                            lambda: S.build_model(model_cfg, params, dev))

    def up(x):
        return S._stage(np.asarray(x, np.float32), dev)

    with torch.inference_mode():
        pred = model(up(roll), up(cond), up(onoff)).float()
    return bulk_griffinlim(pred.transpose(1, 2), np.arange(pred.shape[0]), n_iter=n_iter,
                           hop_length=hp.ws, clip_max=hp.clip_log_power_max, device=dev)
