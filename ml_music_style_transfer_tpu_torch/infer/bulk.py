"""Bulk (multi-clip) synthesis, on one device or over a mesh's data ranks.

Counterpart of the JAX package's ``infer/bulk.py``. The JAX package
inverts a batch of clips with one ``lax.map`` dispatch per device; here the
clips run one after another through the same path as a single request (so
each clip launches the K3 glue kernels ``n_iter`` times): on one card a
stacked batch saves nothing. Phase seeds are explicit and per clip: clip
i's phase is drawn from ``torch.Generator().manual_seed(seeds[i])`` exactly
as a single request draws seed 0, so a batch reproduces single-request
synthesis bit for bit, on any number of ranks.

With a ``mesh`` the clips split over its batch axes (``data``, or ``dcn`` x
``data``; JAX ``bulk.py:31-60``): each rank runs its own clips and the
results are gathered, so every rank of the mesh calls these functions
together and gets every result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_DSP, DSPConfig, ModelConfig
from ..device import resolve_device
from ..ops import griffinlim as tgl
from ..parallel import comm
from ..parallel import mesh as pmesh
from . import synthesize as S


@torch.inference_mode()
def bulk_griffinlim(specs, seeds, mesh=None, n_iter: int = 300, hop_length: int = 256,
                    clip_max: float = 20.0, device: str | torch.device | None = "cuda",
                    init_phase=None):
    """(N, bins, frames) log-power specs -> (N, samples) waveforms on
    ``device`` (this rank's device on a mesh). ``seeds``: N per-clip phase
    seeds; ``init_phase``: (N, bins, frames) initial phases in radians
    instead of the seeds' draws. With ``mesh``, N must divide over its
    batch axes (else ``ValueError``); rank r inverts clips
    [r * N/n, (r + 1) * N/n) and the waveforms are gathered on every rank.

    A 3-D batch is not handed to ``griffinlim`` with one generator: that
    would draw the clips' phases one after another from it, and clip i
    would not equal its single-request result.
    """
    dev = resolve_device(device) if mesh is None else pmesh.mesh_device(mesh)
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    if len(seeds) != len(specs):
        raise ValueError(f"{len(seeds)} seeds for {len(specs)} clips")
    mine = _my_clips(len(specs), mesh)
    phases = [None] * len(specs) if init_phase is None else init_phase
    wavs = torch.stack([
        tgl.griffinlim_from_log_power(
            spec, generator=torch.Generator().manual_seed(seed), n_iter=n_iter,
            hop_length=hop_length, clip_max=clip_max, device=dev, init_phase=phase)
        for spec, seed, phase in zip(specs[mine], seeds[mine], phases[mine])])
    return comm.all_gather_cat(wavs, pmesh.batch_group(mesh), 0)


def _my_clips(n_clips: int, mesh) -> slice:
    """This rank's equal share of ``n_clips`` over the batch axes."""
    n, r = pmesh.batch_size(mesh), pmesh.batch_rank(mesh)
    if n_clips % n:
        raise ValueError(f"clip batch {n_clips} must divide the data axes product {n} "
                         "(pad the batch or change the mesh)")
    k = n_clips // n
    return slice(r * k, (r + 1) * k)


def batch_synthesize_waveforms(synths, n_iter: int = 300, overlap: bool = True,
                               cond_mode: str = "aligned", mesh=None, seeds=None):
    """Dynamic batching for the serving daemon: N requests, each through
    ``synthesize_waveform_async``, all queued before the first is fetched
    (so the host prepares item i+1 while the card runs item i).

    ``seeds``: optional per-request phase seeds, default 0 (=
    ``synthesize_waveform``). Returns ``(wavs, errors)``, both length N: a
    request that fails, on the host or on the card, gets an error string
    and a None waveform and does not fail the rest. With ``mesh`` every
    rank passes the same N requests: request i runs on batch rank
    i mod n, and every rank gets every result.
    """
    n = len(synths)
    fetches: list = [None] * n
    wavs: list = [None] * n
    errors: list = [None] * n
    n_ranks, rank = pmesh.batch_size(mesh), pmesh.batch_rank(mesh)
    for i, s in enumerate(synths):
        if i % n_ranks != rank:
            continue
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
    if n_ranks > 1:
        mine = {i: (wavs[i], errors[i]) for i in range(rank, n, n_ranks)}
        parts = [None] * n_ranks
        torch.distributed.all_gather_object(parts, mine, group=pmesh.batch_group(mesh))
        for part in parts:
            for i, (wav, err) in part.items():
                wavs[i], errors[i] = wav, err
    return wavs, errors


def bulk_synthesize(model_cfg: ModelConfig, params, roll, onoff, cond, mesh=None,
                    n_iter: int = 300, hp: DSPConfig = DEFAULT_DSP,
                    device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Forward + Griffin-Lim for a batch of single-chunk clips.

    ``params``: a state_dict (built once through the serving cache);
    ``roll``/``onoff``: (N, 860, 128); ``cond``: (N, 860, 1025). Returns the
    (N, samples) waveforms on ``device``, clip i with phase seed i. With
    ``mesh`` the clips split over the batch axes: each rank runs the
    forward and Griffin-Lim of its own and the waveforms are gathered.
    """
    dev = resolve_device(device) if mesh is None else pmesh.mesh_device(mesh)
    model = S._cached_model(("inmem", id(params), model_cfg, str(dev)), params,
                            lambda: S.build_model(model_cfg, params, dev))

    mine = _my_clips(len(roll), mesh)

    def up(x):
        return S._stage(np.asarray(x[mine], np.float32), dev)

    with torch.inference_mode():
        pred = model(up(roll), up(cond), up(onoff)).float()
    wavs = bulk_griffinlim(pred.transpose(1, 2), np.arange(len(roll))[mine], n_iter=n_iter,
                           hop_length=hp.ws, clip_max=hp.clip_log_power_max, device=dev)
    return comm.all_gather_cat(wavs, pmesh.batch_group(mesh), 0)
