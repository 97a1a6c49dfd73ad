"""Deployment programs through ``torch.export``: the port's counterpart of
the JAX package's ``compat/stablehlo_export.py``.

Three programs, each a ``torch.export.ExportedProgram`` saved as a ``.pt2``
file (``torch.export.save``) and read back with ``load_artifact``
(``torch.export.load``):

  - forward: (params, midi, cond, onoff) -> log-power spectrogram, the
    deterministic serving forward (reference model/inference.py:74-91);
  - griffinlim: (log-power spec, init_phase, n_iter) -> waveform
    (reference model/inference.py:105-110);
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

The Griffin-Lim loop is one ``while_loop`` node (``ops/griffinlim._iterate``
while exporting), whose body is one iteration, so AOTInductor compiles the
body once instead of 300 copies of it. Its bound is an input: the Griffin-Lim
and serving programs take ``n_iter`` last, a 0-d int64 tensor on the host
(``iterations``), where the loop's counter lives too, so the loop never
waits for the card; the JAX programs fix it at export. Its
consistency glue is traced as the ``mmst_torch::gl_ola_nola`` and
``mmst_torch::gl_frame_window`` operators (``ops/kernels/gl_glue.py``),
which dispatch by device: on the card they launch the hand-written kernels
K3a/K3b, on the CPU their plain versions. So, unlike the JAX export, no
glue needs pinning off, and the program runs wherever its example inputs
lived when it was exported (``device``). The operators are defined in C++
(``csrc/mmst_ops.cpp``): ``load_artifact`` loads their library first.

Python-less deployment: ``compile_package`` compiles an exported program
with AOTInductor (``torch._inductor.aoti_compile_and_package``) into a
package (``{name}.aoti.pt2``; ``write_artifacts(..., aoti=True)`` writes all
three). Inductor generates the pointwise code (the momentum update, the
window products, the blend) and calls cuFFT, cuDNN and the ``mmst_torch``
operators, so a package still launches the hand-written glue kernels.
Parameters, ``init_phase`` and ``n_iter`` stay inputs; the package's
metadata lists the inputs it takes on the host (``HOST_INPUTS_KEY``). A
package runs with no Python
(``csrc/aoti_runner.cpp``, ``run_package(..., runner=True)``) or from a
Python process that imports ``torch`` alone (``compat/aoti_load.py``); both
load the operator library (``ops/kernels/_build.ops_library_path``) first,
and take the inputs flattened in call order (``save_flat_inputs``).
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..config import DEFAULT_DSP, DSPConfig, ModelConfig
from ..device import resolve_device
from ..infer import synthesize
from ..models import PerformanceNet
from ..ops import griffinlim as tgl
from ..ops import kernels as _kernels
from ..ops import stft as tstft


def init_phase(shape, seed: int = 0) -> torch.Tensor:
    """The uniform random phase the serving path draws for ``seed``
    (``torch.Generator().manual_seed(seed)``), as a CPU tensor."""
    return 2.0 * np.pi * torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def iterations(n_iter: int) -> torch.Tensor:
    """The Griffin-Lim and serving programs' ``n_iter`` input: a 0-d int64
    tensor on the host, whatever device the program runs on."""
    return torch.tensor(n_iter, dtype=torch.int64)


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

    _kernels.ops()
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


def export_griffinlim(bins: int = 1025, frames: int = 860,
                      hop_length: int = 256, clip_max: float = 20.0,
                      device: str | torch.device | None = "cuda",
                      transform: str = "fft") -> torch.export.ExportedProgram:
    """Log-power spec -> waveform: (spec (bins, frames), init_phase
    (bins, frames), n_iter (``iterations``)) -> (hop_length * (frames - 1),),
    ``n_iter`` iterations of momentum Griffin-Lim with the ``transform``
    pair (``"fft"``, the serving default, or ``"dft"``)."""
    dev = resolve_device(device)
    _warm_constants(dev, 2 * (bins - 1), hop_length, [frames], transform)

    def synth(spec, phase, n_iter):
        mag = tstft.inverse_log_power(spec, clip_max)
        return tgl.griffinlim(mag, init_phase=phase, n_iter=n_iter, hop_length=hop_length,
                              transform=transform, device=dev)

    args = (torch.empty((bins, frames), device=dev), torch.empty((bins, frames), device=dev),
            iterations(1))
    return _export(synth, args)


def serving_frames(n_tiles: int, hp: DSPConfig = DEFAULT_DSP) -> int:
    """The serving program's output frames (``l_out``): ``n_tiles`` tiles at
    half-chunk hops, rounded up to half a chunk."""
    win = hp.windows_per_chunk
    l_out = (n_tiles - 1) * (win // 2) + win
    return -(-l_out // (win // 2)) * (win // 2)


def export_serving(model_cfg: ModelConfig, n_tiles: int = 8, audio_samples: int = 44100 * 30,
                   hp: DSPConfig = DEFAULT_DSP,
                   device: str | torch.device | None = "cuda",
                   transform: str = "fft") -> torch.export.ExportedProgram:
    """The fused serving program: (params, audio (audio_samples,) f32,
    roll and onoff (n_tiles, 860, 128) int8, starts and cond_starts
    (n_tiles,) int64, valid (n_tiles,) f32, t_total () int64, init_phase
    (1025, l_out), n_iter (``iterations``)) -> waveform (256 * (l_out - 1),),
    with l_out ``serving_frames(n_tiles)``.

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
    i8, i64 = torch.int8, torch.int64
    args = (_param_args(model, dev),
            torch.empty((audio_samples,), device=dev),
            torch.empty((n_tiles, win, model_cfg.start_channels), dtype=i8, device=dev),
            torch.empty((n_tiles, win, model_cfg.start_channels), dtype=i8, device=dev),
            torch.zeros((n_tiles,), dtype=i64, device=dev),
            torch.zeros((n_tiles,), dtype=i64, device=dev),
            torch.empty((n_tiles,), device=dev),
            torch.zeros((), dtype=i64, device=dev),
            torch.empty((bins, l_out), device=dev), iterations(1))
    return _export(serving_fn(model_cfg, n_tiles, hp, dev, transform), args)


def serving_fn(model_cfg: ModelConfig, n_tiles: int = 8, hp: DSPConfig = DEFAULT_DSP,
               device: str | torch.device | None = "cuda", transform: str = "fft"):
    """The function the serving program traces, to call eagerly with the
    program's inputs (``n_iter`` an int or ``iterations``): the live
    serving chain (``export_serving``)."""
    dev = resolve_device(device)
    magnitude = serving_magnitude_fn(model_cfg, n_tiles, hp)

    def serve(params, audio, roll, onoff, starts, cond_starts, valid, t_total, phase, n_iter):
        mag = magnitude(params, audio, roll, onoff, starts, cond_starts, valid, t_total)
        return tgl.griffinlim(mag, init_phase=phase, n_iter=n_iter, hop_length=hp.ws,
                              transform=transform, device=dev)

    return serve


def serving_magnitude_fn(model_cfg: ModelConfig, n_tiles: int = 8,
                         hp: DSPConfig = DEFAULT_DSP):
    """The serving chain before Griffin-Lim, to call eagerly with the
    program's inputs but the phase and the iteration count: the linear magnitude (1025, l_out) that
    Griffin-Lim turns into the waveform."""
    win, l_out = hp.windows_per_chunk, serving_frames(n_tiles, hp)
    forward = _forward_fn(PerformanceNet(model_cfg, device="meta"))

    def magnitude(params, audio, roll, onoff, starts, cond_starts, valid, t_total):
        spec, n_valid = synthesize.cond_spec(audio, hp)
        cond = synthesize.cond_tiles(spec, cond_starts, n_valid, win)
        out = synthesize.forward_blend(functools.partial(forward, params), roll, onoff, cond,
                                       starts, valid, t_total, l_out)
        return tstft.inverse_log_power(out.transpose(0, 1).contiguous(), hp.clip_log_power_max)

    return magnitude


AOTI_SUFFIX = ".aoti.pt2"
# a package's metadata entry: its inputs (flat indices, comma-separated) that
# stay on the host when the package runs on the card (``n_iter``)
HOST_INPUTS_KEY = "mmst_host_inputs"


def loop_bodies(ep: torch.export.ExportedProgram) -> list:
    """The body graphs of the program's ``while_loop`` nodes (the
    Griffin-Lim loop: ``ops/griffinlim.gl_steps`` traces one)."""
    gm = ep.graph_module
    return [getattr(gm, n.args[1].target) for n in gm.graph.nodes
            if n.target is torch.ops.higher_order.while_loop]


def example_inputs(ep: torch.export.ExportedProgram) -> tuple:
    """Uninitialised ``(args, kwargs)`` of the program's input shapes,
    dtypes and devices (``_export`` drops the example inputs; AOTInductor
    needs them)."""
    vals = [n.meta["val"] for n in ep.graph.nodes
            if n.op == "placeholder" and n.name in ep.graph_signature.user_inputs]
    flat = [torch.empty(v.shape, dtype=v.dtype, device=v.device) for v in vals]
    return pytree.tree_unflatten(flat, ep.call_spec.in_spec)


def eager_numerics_configs() -> dict:
    """Inductor options that bring a package's rounding closer to the
    program's: bfloat16 rounded between fused ops
    (``emulate_precision_casts``), and where this PyTorch has them, float32
    division rounded to nearest and PyTorch's own libdevice for the
    transcendental functions (``eager_numerics``). It still rounds
    elsewhere: on the card Griffin-Lim's 300 iterations grow a difference
    of ~7e-7 of the peak after two iterations to 7e-4–6e-2 (PERF.md §6)."""
    configs = {"emulate_precision_casts": True}
    numerics = getattr(torch._inductor.config, "eager_numerics", None)
    for name in ("division_rounding", "use_pytorch_libdevice"):
        if hasattr(numerics, name):
            configs[f"eager_numerics.{name}"] = True
    return configs


def compile_package(ep: torch.export.ExportedProgram, path: str) -> float:
    """Compile ``ep`` with AOTInductor into the package ``path``, for the
    device it was exported on, its host inputs in its metadata
    (``HOST_INPUTS_KEY``); returns the seconds taken."""
    from ..ops.kernels import _build

    _kernels.ops()
    t0 = time.perf_counter()
    ep.example_inputs = example_inputs(ep)
    host = [i for i, t in enumerate(pytree.tree_flatten(ep.example_inputs)[0])
            if t.device.type == "cpu"]
    configs = {**eager_numerics_configs(), "cpp.cxx": (_build.openmp_cxx(),),
               "aot_inductor.metadata": {HOST_INPUTS_KEY: ",".join(map(str, host))}}
    try:
        torch._inductor.aoti_compile_and_package(ep, package_path=path,
                                                 inductor_configs=configs)
    finally:
        ep.example_inputs = None
    return time.perf_counter() - t0


def compile_saved(programs: dict[str, str], out_dir: str) -> dict[str, tuple[str, float]]:
    """Compile saved programs (``{name: .pt2 path}``) into packages
    ``{out_dir}/{name}.aoti.pt2``, each in a process of its own, all at
    once (a compile is mostly one core's work). Returns ``{name: (package
    path, compile seconds)}``; raises if a compile fails."""
    os.makedirs(out_dir, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code = ("import json, sys\n"
            "from ml_music_style_transfer_tpu_torch.compat import program_export as pe\n"
            "print(json.dumps(pe.compile_package(pe.load_artifact(sys.argv[1]), sys.argv[2])))\n")
    penv = dict(os.environ)
    penv["PYTHONPATH"] = os.pathsep.join(p for p in (root, penv.get("PYTHONPATH")) if p)
    procs = {}
    for name, program in programs.items():
        package = os.path.join(out_dir, name + AOTI_SUFFIX)
        procs[name] = (package, subprocess.Popen(
            [sys.executable, "-c", code, program, package], env=penv, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out, failed = {}, []
    for name, (package, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{stderr[-4000:]}")
        else:
            out[name] = (package, json.loads(stdout.strip().splitlines()[-1]))
    if failed:
        raise RuntimeError("AOTInductor compile failed: " + "\n".join(failed))
    return out


def save_flat_inputs(path: str, *args) -> None:
    """A program's inputs, flattened in its call order (the parameters dict
    in its order first), as a list of CPU tensors, the file a package's
    runner reads."""
    flat = pytree.tree_flatten((args, {}))[0]
    torch.save([t.detach().cpu().contiguous() for t in flat], path)


def run_package(package: str, inputs: str, output: str, runs: int = 1,
                runner: bool = True, timeout: float = 1800) -> dict:
    """Run ``package`` on the saved ``inputs`` in a new process: the C++
    runner (``runner=True``, no Python in the process) or ``aoti_load.py``
    in a Python that imports ``torch`` alone. Its outputs are saved at
    ``output`` (a list of tensors); returns its report (device, load and
    run seconds, launches per run). Raises if the process fails."""
    from ..ops.kernels import _build

    if runner:
        cmd = [_build.build_runner(), package, inputs, output, str(runs)]
    else:
        _build.build_all()
        cmd = [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            "aoti_load.py"),
               package, _build.ops_library_path(), inputs, output, str(runs)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed on {package} "
                           f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def write_artifacts(out_dir: str, model_cfg: ModelConfig, t: int = 860, batch: int = 1,
                    frames: int = 860,
                    device: str | torch.device | None = "cuda", serving_n_tiles: int = 8,
                    serving_audio_samples: int = 44100 * 30, transform: str = "fft",
                    aoti: bool = False) -> dict:
    """Export the forward, Griffin-Lim and serving programs into
    ``out_dir`` as ``{name}.pt2`` beside a ``manifest.json`` (which records
    each program's export seconds); with ``aoti``, each exported program is
    also compiled into ``{name}.aoti.pt2`` (seconds in the manifest's
    ``aoti_compile_seconds``; keys ``{name}.aoti``). Returns ``{name: path}``.
    ``serving_n_tiles=0`` skips the serving program."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    jobs = [("forward", lambda: export_forward(model_cfg, t=t, batch=batch, device=dev)),
            ("griffinlim", lambda: export_griffinlim(frames=frames, device=dev,
                                                     transform=transform))]
    if serving_n_tiles:
        jobs.append(("serving", lambda: export_serving(
            model_cfg, n_tiles=serving_n_tiles, audio_samples=serving_audio_samples,
            device=dev, transform=transform)))
    paths, seconds, aoti_seconds = {}, {}, {}
    for name, job in jobs:
        t0 = time.perf_counter()
        ep = job()
        seconds[name] = time.perf_counter() - t0
        paths[name] = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(ep, paths[name])
        if aoti:
            paths[f"{name}.aoti"] = os.path.join(out_dir, name + AOTI_SUFFIX)
            aoti_seconds[name] = compile_package(ep, paths[f"{name}.aoti"])
    manifest = {
        "torch_version": torch.__version__,
        "device": str(dev),
        "transform": transform,
        "init_phase": "input: radians, the (bins, frames) shape of the magnitude",
        "forward": {"t": t, "batch": batch, "width_mult": model_cfg.width_mult,
                    "compat_mbr_noop": model_cfg.compat_mbr_noop,
                    "compute_dtype": model_cfg.compute_dtype,
                    "inputs": ["params", "midi", "cond", "onoff"]},
        "n_iter": "input: a 0-d int64 tensor on the host, the Griffin-Lim iterations",
        "griffinlim": {"frames": frames, "inputs": ["spec", "init_phase", "n_iter"]},
        "export_seconds": seconds,
    }
    if aoti:
        manifest["aoti_compile_seconds"] = aoti_seconds
    if serving_n_tiles:
        manifest["serving"] = {
            "n_tiles": serving_n_tiles, "audio_samples": serving_audio_samples,
            "frames": serving_frames(serving_n_tiles),
            "inputs": ["params", "audio", "roll", "onoff", "starts", "cond_starts", "valid",
                       "t_total", "init_phase", "n_iter"]}
    paths["manifest"] = os.path.join(out_dir, "manifest.json")
    with open(paths["manifest"], "w") as f:
        json.dump(manifest, f, indent=2)
    return paths


def load_artifact(path: str) -> torch.export.ExportedProgram:
    """A ``.pt2`` program, the operator library it names loaded first; call
    ``.module()(*inputs)`` on it."""
    _kernels.ops()
    return torch.export.load(path)
