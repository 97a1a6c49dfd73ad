"""AOTInductor packages of the deployment programs (``compat/program_export``
``compile_package``) on the CPU, at width 1/16 in float32: a Griffin-Lim
package and a serving package, compiled once for the module from their
saved programs (``compile_saved``, side by side), each run in a new process
twice over: by the C++ runner (``csrc/aoti_runner.cpp``, no Python in the
process) and by ``compat/aoti_load.py`` in a Python that imports torch
alone. Each run is held to the live port and to the JAX
package's chain from the same phase, and its launch report to the
operators the package calls (on the CPU: their CPU implementations)."""
import json
import subprocess
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.infer.synthesize import _predict_blend_jit
from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
from ml_music_style_transfer_tpu.ops import griffinlim as jgl
from ml_music_style_transfer_tpu.ops import stft as jstft
from ml_music_style_transfer_tpu_torch.compat import from_jax_params, program_export
from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.ops.kernels import _build
from ml_music_style_transfer_tpu_torch.scripts import export_program

TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32")
T = 220
GL_FRAMES, GL_ITERS = 48, 4
N_TILES, AUDIO_SAMPLES, SERVE_ITERS = 4, 3 * 44100, 3
# of the waveform's peak, against the live port: Griffin-Lim 1e-4 (float32
# FFT rounding; the package, the live port and JAX agree to ~3e-6); serving
# 2e-4, just above the 1.1e-4 that Inductor's own float32 reductions move
# the package from the live port
TOL = {"griffinlim": 1e-4, "serving": 2e-4}
# against JAX's chain: serving 1e-3, the live port's own tolerance there
# (tests/test_torch_port_export.py: the forward's float32 tolerance through
# Griffin-Lim; the live port is ~4e-4 from JAX)
JAX_TOL = {"griffinlim": 1e-4, "serving": 1e-3}
GLUE = ("gl_ola_nola", "gl_frame_window")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads per module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_params():
    model = JPerformanceNet(JModelConfig(**TINY_KW))
    z = jnp.zeros((1, T, 128))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), z, jnp.zeros((1, T, 1025)), z)
    return jax.tree_util.tree_map(np.asarray, params)


def _serving_inputs():
    """A request as numpy arrays (as tests/test_torch_port_export.py's)."""
    rng = np.random.default_rng(5)
    audio = (0.3 * rng.standard_normal(AUDIO_SAMPLES)).astype(np.float32)
    roll = (rng.random((N_TILES, 860, 128)) < 0.05).astype(np.int8)
    onoff = rng.integers(-1, 2, (N_TILES, 860, 128)).astype(np.int8)
    starts = np.array([0, 430, 860, 1290])
    cond_starts = np.array([0, 430, 500, 0])
    valid = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    return audio, roll, onoff, starts, cond_starts, valid, 2000


def _jax_griffinlim(mag, phase, n_iter):
    return np.asarray(jgl.griffinlim(mag, n_iter=n_iter, init_phase=jnp.asarray(phase.numpy()),
                                     use_pallas_glue=False, transform="fft"))


@pytest.fixture(scope="module")
def cases(tmp_path_factory, flax_params):
    """Both packages compiled (in two processes, while this one builds the
    runner and computes the references), their inputs saved, and what each
    must give: the live port's output and the JAX chain's."""
    d = tmp_path_factory.mktemp("packages")
    cfg = ModelConfig(**TINY_KW)
    programs = {"griffinlim": program_export.export_griffinlim(frames=GL_FRAMES, device="cpu"),
                "serving": program_export.export_serving(
                    cfg, n_tiles=N_TILES, audio_samples=AUDIO_SAMPLES, device="cpu")}
    for name, ep in programs.items():
        torch.export.save(ep, str(d / f"{name}.pt2"))
    compiled = {}
    compiling = threading.Thread(target=lambda: compiled.update(program_export.compile_saved(
        {name: str(d / f"{name}.pt2") for name in programs}, str(d))))
    runner = threading.Thread(target=_build.build_runner)
    env = pytest.MonkeyPatch()
    env.setenv("TORCHINDUCTOR_COMPILE_THREADS", "1")  # six test workers share the machine
    compiling.start()
    runner.start()
    try:
        spec = (np.random.default_rng(1).random((1025, GL_FRAMES), dtype=np.float32) * 8.0)
        phase = program_export.init_phase(spec.shape, 3)
        gl_args = (torch.from_numpy(spec), phase, program_export.iterations(GL_ITERS))
        with torch.inference_mode():
            gl_live = tgl.griffinlim(tstft.inverse_log_power(gl_args[0]), init_phase=phase,
                                     n_iter=GL_ITERS, device="cpu")
            gl_live_1 = tgl.griffinlim(tstft.inverse_log_power(gl_args[0]), init_phase=phase,
                                       n_iter=1, device="cpu")
        gl_jax = _jax_griffinlim(jnp.sqrt(jnp.expm1(jnp.clip(jnp.asarray(spec), 0.0, 20.0))),
                                 phase, GL_ITERS)

        params = program_export.program_params(from_jax_params(flax_params), cfg)
        audio, roll, onoff, starts, cond_starts, valid, t_total = _serving_inputs()
        l_out = program_export.serving_frames(N_TILES)
        s_phase = program_export.init_phase((1025, l_out), 6)
        arrays = (audio, roll, onoff, starts, cond_starts, valid)
        s_args = (params, *map(torch.from_numpy, arrays), torch.tensor(t_total), s_phase,
                  program_export.iterations(SERVE_ITERS))
        with torch.inference_mode():
            s_live = program_export.serving_fn(cfg, N_TILES, device="cpu")(*s_args)
        jspec = jnp.swapaxes(jstft.log_power_stft(jnp.asarray(audio), 2048, 256), -1, -2)
        idx = (jnp.asarray(cond_starts)[:, None] + jnp.arange(860)[None, :]) % jspec.shape[0]
        pred = _predict_blend_jit(JModelConfig(**TINY_KW))(
            flax_params, jnp.asarray(roll), jnp.asarray(onoff), jspec[idx],
            jnp.asarray(starts, jnp.int32), jnp.asarray(valid), jnp.int32(t_total), l_out=l_out)
        s_jax = _jax_griffinlim(jnp.sqrt(jnp.expm1(jnp.clip(pred.T, 0.0, 20.0))), s_phase,
                                SERVE_ITERS)
    finally:
        compiling.join()
        runner.join()
        env.undo()
    out = {}
    for name, args, live, want, n_iter in (
            ("griffinlim", gl_args, gl_live, gl_jax, GL_ITERS),
            ("serving", s_args, s_live, s_jax, SERVE_ITERS)):
        inputs = str(d / f"{name}_in.pt")
        program_export.save_flat_inputs(inputs, *args)
        out[name] = {"package": compiled[name][0], "inputs": inputs, "live": live.numpy(),
                     "jax": want, "n_iter": n_iter, "dir": d}
    inputs = str(d / "griffinlim_1_in.pt")
    program_export.save_flat_inputs(inputs, *gl_args[:2], program_export.iterations(1))
    out["griffinlim_1"] = {"inputs": inputs, "live": gl_live_1.numpy()}
    return out


@pytest.mark.parametrize("name", ["griffinlim", "serving"])
@pytest.mark.parametrize("runner", [True, False], ids=["cpp_runner", "torch_only_python"])
def test_package_matches_the_live_port_and_jax(cases, name, runner):
    """Two runs of the package in a new process: each output within ``TOL``
    of the peak of the live port and ``JAX_TOL`` of the JAX chain's; n_iter CPU calls of
    each glue operator per run, no CUDA launch, no other operator."""
    case = cases[name]
    out = str(case["dir"] / f"{name}_{runner}_out.pt")
    rep = program_export.run_package(case["package"], case["inputs"], out, runs=2,
                                     runner=runner)
    assert rep["device"] == "cpu" and len(rep["run_s"]) == 2
    if not runner:
        assert rep["repo_modules"] == []
    for entry, calls in rep["launches"].items():
        want = [case["n_iter"]] * 2 if entry in GLUE else [0, 0]
        assert calls == {"cuda": [0, 0], "cpu": want}, entry
    (got,) = torch.load(out)
    got = got.numpy()
    for want, tol in ((case["live"], TOL[name]), (case["jax"], JAX_TOL[name])):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_package_takes_the_iteration_count(cases):
    """The Griffin-Lim package's ``n_iter`` input, kept on the host by the
    runner: one iteration, one call of each glue operator, within 1e-4 of
    the peak of the live port's one iteration."""
    case = cases["griffinlim"]
    out = str(case["dir"] / "griffinlim_1_out.pt")
    rep = program_export.run_package(case["package"], cases["griffinlim_1"]["inputs"], out)
    assert {e: rep["launches"][e] for e in GLUE} == {e: {"cuda": [0], "cpu": [1]} for e in GLUE}
    (got,) = torch.load(out)
    want = cases["griffinlim_1"]["live"]
    assert np.abs(got.numpy() - want).max() <= TOL["griffinlim"] * np.abs(want).max()


def test_runner_has_no_python():
    """``ldd`` of the runner: the operator library and libtorch, no
    libpython."""
    ldd = subprocess.run(["ldd", _build.build_runner()], capture_output=True, text=True,
                         check=True).stdout
    assert "libmmst_ops.so" in ldd and "libtorch_cpu.so" in ldd
    assert "libpython" not in ldd


def test_export_program_aoti_flag(tmp_path, capsys, monkeypatch):
    """``--aoti`` compiles each exported program (the compile itself is
    the fixture's, so here a stand-in writes the package) and records the
    seconds in the manifest."""
    compiled = []

    def fake_compile(ep, path):
        compiled.append(ep)
        open(path, "wb").close()
        return 1.5

    monkeypatch.setattr(program_export, "compile_package", fake_compile)
    paths = export_program.main(["--out", str(tmp_path), "--width-mult", "0.0625",
                                 "--t", str(T), "--frames", "32",
                                 "--serving-n-tiles", "0", "--device", "cpu", "--aoti"])
    assert set(paths) == {"forward", "griffinlim", "forward.aoti", "griffinlim.aoti",
                          "manifest"}
    assert paths["griffinlim.aoti"].endswith("griffinlim.aoti.pt2")
    assert all(isinstance(ep, torch.export.ExportedProgram) for ep in compiled)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["aoti_compile_seconds"] == {"forward": 1.5, "griffinlim": 1.5}
    assert "compiled in 1.5 s" in capsys.readouterr().out


def test_example_inputs_rebuild_the_program_signature():
    """``torch.export.save`` drops the example inputs; AOTInductor needs
    them: rebuilt from the program's placeholders, in its call structure."""
    ep = program_export.export_griffinlim(frames=32, device="cpu")
    args, kwargs = program_export.example_inputs(ep)
    assert kwargs == {} and [tuple(a.shape) for a in args] == [(1025, 32), (1025, 32), ()]
    assert [a.dtype for a in args] == [torch.float32, torch.float32, torch.int64]
    assert all(a.device.type == "cpu" for a in args)
