"""Deployment programs through ``torch.export``: the port's counterpart of
the JAX package's ``compat/stablehlo_export.py``.

Three programs, each a ``torch.export.ExportedProgram`` saved as a ``.pt2``
file (``torch.export.save``) and read back with ``load_artifact``
(``torch.export.load``):

  - forward: (params, midi, cond, onoff) -> log-power spectrogram, the
    deterministic serving forward (reference model/inference.py:74-91);
  - griffinlim: (log-power spec, init_phase) -> waveform at a fixed
    iteration count (reference model/inference.py:105-110);
  - serving: the whole device chain of one request, through the functions
    ``AudioSynthesizer.synthesize_waveform`` runs: the timbre waveform's
    bucketed log-power STFT (``synthesize.cond_spec``), the cyclic per-tile
    conditioning gather (``cond_tiles``), the batched tiled forward and the
    triangular crossfade blend (``forward_blend``), and Griffin-Lim.

Parameters are inputs, not constants, as in the JAX programs: the model is
built on the ``meta`` device and the program calls
``torch.func.functional_call`` with the parameters it is given, so the
file holds no weights (a few MB of window and NOLA constants) and one
program serves every checkpoint of the configuration.

Programs take the parameters as a dict in the model's parameter order
(``program_params``). The random phase is an input too. The JAX programs take a PRNG key; a
``torch.Generator`` cannot be traced, so the Griffin-Lim and serving
programs take ``init_phase`` (radians, the magnitude's (bins, frames)
shape). ``2 * pi * torch.rand(shape, generator=torch.Generator()
.manual_seed(seed))`` gives the phase the serving path draws for ``seed``.

The Griffin-Lim loop is unrolled: 300 iterations are some 4,500 nodes. Its
consistency glue is traced as the ``mmst_torch::gl_ola_nola`` and
``mmst_torch::gl_frame_window`` operators (``ops/kernels/gl_glue.py``),
which dispatch by device: on the card they launch the hand-written kernels
K3a/K3b, on the CPU their plain versions. So, unlike the JAX export, no
glue needs pinning off, and the program runs wherever its example inputs
lived when it was exported (``device``). Loading a program needs this
package imported first, since it registers the operators.
"""
from __future__ import annotations

import functools
import json
import os
import time

import numpy as np
import torch

from ..config import DEFAULT_DSP, DSPConfig, ModelConfig
from ..device import resolve_device
from ..infer import synthesize
from ..models import PerformanceNet
from ..ops import griffinlim as tgl
from ..ops import stft as tstft


def init_phase(shape, seed: int = 0) -> torch.Tensor:
    """The uniform random phase the serving path draws for ``seed``
    (``torch.Generator().manual_seed(seed)``), as a CPU tensor."""
    return 2.0 * np.pi * torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _warm_constants(device: torch.device, n_fft: int, hop: int, frames: list[int],
                    transform: str) -> None:
    """Make the cached window, NOLA and DFT constants outside the trace, so
    the trace reads them as constants and the caches never hold a traced
    tensor. The caches key on the device as a tensor reports it
    (``cuda:0``, not ``cuda``)."""
    device = torch.empty(0, device=device).device
    tstft.window_tensor(n_fft, n_fft, device)
    for n in frames:
        tstft.wss_inv_tensor(n_fft, n_fft, hop, n, device)
    if transform == "dft":
        tstft.dft_matrices(n_fft, torch.bfloat16 if device.type == "cuda" else torch.float32,
                           device)


def _export(fn, args: tuple) -> torch.export.ExportedProgram:
    """``torch.export`` of ``fn(*args)``; the kernels' calls are traced as
    their operators. The example inputs are dropped: ``torch.export.save``
    would write them (the parameters' 2.9 GB at full width) into the file."""

    class Program(torch.nn.Module):
        def forward(self, *a):
            return fn(*a)

    with torch.no_grad():
        ep = torch.export.export(Program(), args, strict=False)
    ep.example_inputs = None
    return ep


def _param_args(model: PerformanceNet, device: torch.device) -> dict[str, torch.Tensor]:
    """Example parameters for the trace: uninitialised, on ``device``."""
    return {k: torch.empty(p.shape, dtype=p.dtype, device=device)
            for k, p in model.named_parameters()}


def program_params(params, model_cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """``params`` (a state_dict by the reference's keys) as the forward and
    serving programs take them: a dict in the model's parameter order,
    which the program's input spec fixed. A missing key raises KeyError."""
    return {k: params[k] for k, _ in PerformanceNet(model_cfg, device="meta").named_parameters()}


def _forward_fn(model: PerformanceNet):
    def forward(params, midi, cond, onoff):
        return torch.func.functional_call(model, params, (midi, cond, onoff),
                                          {"deterministic": True})

    return forward


def export_forward(model_cfg: ModelConfig, t: int = 860, batch: int = 1,
                   device: str | torch.device | None = "cuda") -> torch.export.ExportedProgram:
    """The deterministic serving forward: (params, midi (B, T, 128),
    cond (B, T, 1025), onoff (B, T, 128)) -> (B, T', 1025) float32."""
    dev = resolve_device(device)
    model = PerformanceNet(model_cfg, device="meta")
    args = (_param_args(model, dev),
            torch.empty((batch, t, model_cfg.start_channels), device=dev),
            torch.empty((batch, t, model_cfg.start_audio_channels), device=dev),
            torch.empty((batch, t, model_cfg.start_channels), device=dev))
    return _export(_forward_fn(model), args)


def export_griffinlim(n_iter: int = 300, bins: int = 1025, frames: int = 860,
                      hop_length: int = 256, clip_max: float = 20.0,
                      device: str | torch.device | None = "cuda",
                      transform: str = "fft") -> torch.export.ExportedProgram:
    """Log-power spec -> waveform: (spec (bins, frames), init_phase
    (bins, frames)) -> (hop_length * (frames - 1),), ``n_iter`` iterations
    of momentum Griffin-Lim with the ``transform`` pair (``"fft"``, the
    serving default, or ``"dft"``)."""
    dev = resolve_device(device)
    _warm_constants(dev, 2 * (bins - 1), hop_length, [frames], transform)

    def synth(spec, phase):
        mag = tstft.inverse_log_power(spec, clip_max)
        return tgl.griffinlim(mag, init_phase=phase, n_iter=n_iter, hop_length=hop_length,
                              transform=transform, device=dev)

    args = (torch.empty((bins, frames), device=dev), torch.empty((bins, frames), device=dev))
    return _export(synth, args)


def serving_frames(n_tiles: int, hp: DSPConfig = DEFAULT_DSP) -> int:
    """The serving program's output frames (``l_out``): ``n_tiles`` tiles at
    half-chunk hops, rounded up to half a chunk."""
    win = hp.windows_per_chunk
    l_out = (n_tiles - 1) * (win // 2) + win
    return -(-l_out // (win // 2)) * (win // 2)


def export_serving(model_cfg: ModelConfig, n_tiles: int = 8, audio_samples: int = 44100 * 30,
                   n_iter: int = 300, hp: DSPConfig = DEFAULT_DSP,
                   device: str | torch.device | None = "cuda",
                   transform: str = "fft") -> torch.export.ExportedProgram:
    """The fused serving program: (params, audio (audio_samples,) f32,
    roll and onoff (n_tiles, 860, 128) int8, starts and cond_starts
    (n_tiles,) int64, valid (n_tiles,) f32, t_total () int64, init_phase
    (1025, l_out)) -> waveform (256 * (l_out - 1),), with l_out
    ``serving_frames(n_tiles)``.

    Shapes are fixed at export: pad short clips with valid=0 tiles (the
    serving path's bucketing of the tile count); ``t_total`` stays a
    run-time scalar (frames past it are silence before Griffin-Lim). The
    conditioning is the serving path's: the timbre waveform reflect-padded
    and zero-padded to its half-chunk frame bucket, its log-power STFT
    gathered per tile modulo its true frame count ``1 + audio_samples //
    256``."""
    dev = resolve_device(device)
    win, bins = hp.windows_per_chunk, hp.n_freq_bins
    l_out = serving_frames(n_tiles, hp)
    _warm_constants(dev, hp.n_fft, hp.ws, [l_out], transform)
    model = PerformanceNet(model_cfg, device="meta")
    forward = _forward_fn(model)

    def serve(params, audio, roll, onoff, starts, cond_starts, valid, t_total, phase):
        spec, n_valid = synthesize.cond_spec(audio, hp)
        cond = synthesize.cond_tiles(spec, cond_starts, n_valid, win)
        out = synthesize.forward_blend(functools.partial(forward, params), roll, onoff, cond,
                                       starts, valid, t_total, l_out)
        mag = tstft.inverse_log_power(out.transpose(0, 1).contiguous(), hp.clip_log_power_max)
        return tgl.griffinlim(mag, init_phase=phase, n_iter=n_iter, hop_length=hp.ws,
                              transform=transform, device=dev)

    i8, i64 = torch.int8, torch.int64
    args = (_param_args(model, dev),
            torch.empty((audio_samples,), device=dev),
            torch.empty((n_tiles, win, model_cfg.start_channels), dtype=i8, device=dev),
            torch.empty((n_tiles, win, model_cfg.start_channels), dtype=i8, device=dev),
            torch.zeros((n_tiles,), dtype=i64, device=dev),
            torch.zeros((n_tiles,), dtype=i64, device=dev),
            torch.empty((n_tiles,), device=dev),
            torch.zeros((), dtype=i64, device=dev),
            torch.empty((bins, l_out), device=dev))
    return _export(serve, args)


def write_artifacts(out_dir: str, model_cfg: ModelConfig, t: int = 860, batch: int = 1,
                    n_iter: int = 300, frames: int = 860,
                    device: str | torch.device | None = "cuda", serving_n_tiles: int = 8,
                    serving_audio_samples: int = 44100 * 30, transform: str = "fft") -> dict:
    """Export the forward, Griffin-Lim and serving programs into
    ``out_dir`` as ``{name}.pt2`` beside a ``manifest.json`` (which records
    each program's export seconds); returns ``{name: path}``.
    ``serving_n_tiles=0`` skips the serving program."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    jobs = [("forward", lambda: export_forward(model_cfg, t=t, batch=batch, device=dev)),
            ("griffinlim", lambda: export_griffinlim(n_iter=n_iter, frames=frames, device=dev,
                                                     transform=transform))]
    if serving_n_tiles:
        jobs.append(("serving", lambda: export_serving(
            model_cfg, n_tiles=serving_n_tiles, audio_samples=serving_audio_samples,
            n_iter=n_iter, device=dev, transform=transform)))
    paths, seconds = {}, {}
    for name, job in jobs:
        t0 = time.perf_counter()
        ep = job()
        seconds[name] = time.perf_counter() - t0
        paths[name] = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(ep, paths[name])
    manifest = {
        "torch_version": torch.__version__,
        "device": str(dev),
        "transform": transform,
        "init_phase": "input: radians, the (bins, frames) shape of the magnitude",
        "forward": {"t": t, "batch": batch, "width_mult": model_cfg.width_mult,
                    "compat_mbr_noop": model_cfg.compat_mbr_noop,
                    "compute_dtype": model_cfg.compute_dtype,
                    "inputs": ["params", "midi", "cond", "onoff"]},
        "griffinlim": {"n_iter": n_iter, "frames": frames, "inputs": ["spec", "init_phase"]},
        "export_seconds": seconds,
    }
    if serving_n_tiles:
        manifest["serving"] = {
            "n_tiles": serving_n_tiles, "audio_samples": serving_audio_samples,
            "n_iter": n_iter, "frames": serving_frames(serving_n_tiles),
            "inputs": ["params", "audio", "roll", "onoff", "starts", "cond_starts", "valid",
                       "t_total", "init_phase"]}
    paths["manifest"] = os.path.join(out_dir, "manifest.json")
    with open(paths["manifest"], "w") as f:
        json.dump(manifest, f, indent=2)
    return paths


def load_artifact(path: str) -> torch.export.ExportedProgram:
    """A ``.pt2`` program; call ``.module()(*inputs)`` on it."""
    return torch.export.load(path)
