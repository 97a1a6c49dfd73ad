"""The port's deployment programs (``compat/program_export.py``,
``torch.export``) against the JAX package's ``compat/stablehlo_export.py``
and its live serving chain on the CPU, at width 1/16 in float32: the same
weights (``from_jax_params``) and the same inputs, made from a seed with
numpy, go through both. Each port program is saved to a ``.pt2`` file and
loaded back before it runs, and once more in a fresh process."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.compat import stablehlo_export as jexport
from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.infer.synthesize import _predict_blend_jit
from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
from ml_music_style_transfer_tpu.ops import griffinlim as jgl
from ml_music_style_transfer_tpu.ops import stft as jstft
from ml_music_style_transfer_tpu_torch.compat import from_jax_params, program_export
from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.scripts import export_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32")
T = 220
GL_FRAMES, GL_ITERS = 48, 4
N_TILES, AUDIO_SAMPLES, SERVE_ITERS = 4, 3 * 44100, 3


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


@pytest.fixture(scope="module")
def params(flax_params):
    return program_export.program_params(from_jax_params(flax_params), ModelConfig(**TINY_KW))


def _saved_and_loaded(ep, path):
    torch.export.save(ep, str(path))
    return program_export.load_artifact(str(path))


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    d = tmp_path_factory.mktemp("programs")
    cfg = ModelConfig(**TINY_KW)
    return {
        "forward": _saved_and_loaded(program_export.export_forward(cfg, t=T, device="cpu"),
                                     d / "forward.pt2"),
        "griffinlim": _saved_and_loaded(program_export.export_griffinlim(
            frames=GL_FRAMES, device="cpu"), d / "griffinlim.pt2"),
        "serving": _saved_and_loaded(program_export.export_serving(
            cfg, n_tiles=N_TILES, audio_samples=AUDIO_SAMPLES, device="cpu"),
            d / "serving.pt2"),
        "dir": d,
    }


def _close(got, want, rel=1e-4, of_peak=1e-4):
    """|got - want| <= rel |want| + of_peak * peak, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = rel * np.abs(want) + of_peak * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound), float(np.abs(got - want).max())


def _log_spec(rng, frames):
    return (rng.random((1025, frames), dtype=np.float32) * 8.0).astype(np.float32)


class TestForward:
    def test_matches_the_jax_artifact(self, programs, flax_params, params):
        """Both serialized, deserialized and run on the CPU; the forward's
        stated tolerance, 1e-4 relative plus 1e-4 of the peak (float32
        through ~30 layers, tests/test_torch_port_model.py)."""
        exp = jax.export.deserialize(jexport.export_forward(JModelConfig(**TINY_KW), t=T)
                                     .serialize())
        rng = np.random.default_rng(0)
        midi = (rng.random((1, T, 128)) < 0.05).astype(np.float32)
        cond = rng.random((1, T, 1025), dtype=np.float32) * 8.0
        onoff = rng.integers(-1, 2, (1, T, 128)).astype(np.float32)
        want = np.asarray(exp.call(flax_params, midi, cond, onoff))
        with torch.inference_mode():
            got = programs["forward"].module()(
                params, *(torch.from_numpy(a) for a in (midi, cond, onoff)))
        _close(got.numpy(), want)

    @pytest.mark.parametrize("name", ["forward", "griffinlim", "serving"])
    def test_parameters_are_inputs(self, programs, params, name):
        ep = programs[name]
        assert ep.state_dict == {} and not ep.graph_signature.parameters
        shapes = {tuple(p.shape) for p in params.values()}
        assert not any(tuple(c.shape) in shapes and c.numel() > 1024
                       for c in ep.constants.values())


class TestGriffinLim:
    def test_matches_jax_from_the_same_phase(self, programs):
        """4 iterations at 48 frames: 1e-3 of the waveform's peak (float32
        FFT rounding; the bound of the port's other Griffin-Lim parity
        tests)."""
        rng = np.random.default_rng(1)
        spec = _log_spec(rng, GL_FRAMES)
        phase = program_export.init_phase(spec.shape, 3)
        mag = jnp.sqrt(jnp.expm1(jnp.clip(jnp.asarray(spec), 0.0, 20.0)))
        want = np.asarray(jgl.griffinlim(mag, n_iter=GL_ITERS, init_phase=jnp.asarray(phase.numpy()),
                                         use_pallas_glue=False, transform="fft"))
        with torch.inference_mode():
            got = programs["griffinlim"].module()(torch.from_numpy(spec), phase,
                                                  program_export.iterations(GL_ITERS))
        assert got.shape == (256 * (GL_FRAMES - 1),)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * np.abs(want).max())

    def test_program_equals_the_live_path(self, programs):
        """The program's loop (one ``while_loop`` over the real-valued
        iteration) replays the live ``griffinlim``'s operations: bit-equal."""
        from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
        from ml_music_style_transfer_tpu_torch.ops import stft as tstft

        spec = torch.from_numpy(_log_spec(np.random.default_rng(12), GL_FRAMES))
        phase = program_export.init_phase(spec.shape, 13)
        with torch.inference_mode():
            got = programs["griffinlim"].module()(spec, phase, program_export.iterations(GL_ITERS))
            want = tgl.griffinlim(tstft.inverse_log_power(spec), init_phase=phase,
                                  n_iter=GL_ITERS, device="cpu")
        assert torch.equal(got, want)

    def test_dft_transform_equals_the_live_path(self):
        """``transform="dft"`` stays selectable: the program equals the
        port's live ``griffinlim`` with the same transform, and its glue is
        the operators too."""
        from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
        from ml_music_style_transfer_tpu_torch.ops import stft as tstft

        ep = program_export.export_griffinlim(frames=32, device="cpu", transform="dft")
        spec = torch.from_numpy(_log_spec(np.random.default_rng(10), 32))
        phase = program_export.init_phase(spec.shape, 11)
        with torch.inference_mode():
            got = ep.module()(spec, phase, program_export.iterations(2))
            want = tgl.griffinlim(tstft.inverse_log_power(spec), init_phase=phase, n_iter=2,
                                  transform="dft", device="cpu")
        assert torch.equal(got, want)
        (body,) = program_export.loop_bodies(ep)
        targets = [n.target for n in body.graph.nodes]
        assert targets.count(torch.ops.mmst_torch.gl_ola_nola.default) == 1

    def test_graph_holds_one_glue_pair_per_iteration(self, programs):
        """The loop is one ``while_loop`` whose body (one iteration) holds
        one pair of glue operators; a run calls each as many times as its
        ``n_iter`` input says (the operator library's CPU counts)."""
        from ml_music_style_transfer_tpu_torch.ops.kernels import _library, gl_glue

        (body,) = program_export.loop_bodies(programs["griffinlim"])
        targets = [n.target for n in body.graph.nodes if n.op == "call_function"]
        assert targets.count(torch.ops.mmst_torch.gl_ola_nola.default) == 1
        assert targets.count(torch.ops.mmst_torch.gl_frame_window.default) == 1
        spec = torch.from_numpy(_log_spec(np.random.default_rng(9), GL_FRAMES))
        for n_iter in (GL_ITERS, 1):
            gl_glue.reset_launches()
            with torch.inference_mode():
                programs["griffinlim"].module()(spec, program_export.init_phase(spec.shape),
                                                program_export.iterations(n_iter))
            assert _library.launch_count("gl_ola_nola", "cpu") == n_iter
            assert _library.launch_count("gl_frame_window", "cpu") == n_iter


def _serving_inputs():
    """A request for the serving program, as numpy arrays: timbre audio,
    int8 roll and onoff tiles, tile and conditioning starts, valid flags,
    the true frame count, and the initial phase (a tensor)."""
    rng = np.random.default_rng(5)
    win = 860
    audio = (0.3 * rng.standard_normal(AUDIO_SAMPLES)).astype(np.float32)
    roll = (rng.random((N_TILES, win, 128)) < 0.05).astype(np.int8)
    onoff = rng.integers(-1, 2, (N_TILES, win, 128)).astype(np.int8)
    starts = np.array([0, 430, 860, 1290])
    cond_starts = np.array([0, 430, 500, 0])
    valid = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    phase = program_export.init_phase((1025, program_export.serving_frames(N_TILES)), 6)
    return audio, roll, onoff, starts, cond_starts, valid, 2000, phase


def _program_args(params, audio, roll, onoff, starts, cond_starts, valid, t_total, phase):
    """The serving program's inputs for that request, at SERVE_ITERS iterations."""
    return (params, *(torch.from_numpy(a) for a in (audio, roll, onoff, starts, cond_starts,
                                                     valid)), torch.tensor(t_total), phase,
            program_export.iterations(SERVE_ITERS))


class TestServing:
    def test_matches_the_jax_live_chain(self, programs, flax_params, params):
        """The JAX chain the JAX serving program fuses: ``log_power_stft``
        of the timbre audio, the cyclic gather, ``_predict_blend_jit`` and
        ``griffinlim``, from the same phase. 3 iterations: 1e-3 of the
        waveform's peak (the forward's 1e-4 tolerance through float32
        Griffin-Lim, as in TestGriffinLim)."""
        inputs = _serving_inputs()
        audio, roll, onoff, starts, cond_starts, valid, t_total, phase = inputs
        win, l_out = 860, program_export.serving_frames(N_TILES)

        spec = jnp.swapaxes(jstft.log_power_stft(jnp.asarray(audio), 2048, 256), -1, -2)
        idx = (jnp.asarray(cond_starts)[:, None] + jnp.arange(win)[None, :]) % spec.shape[0]
        pred = _predict_blend_jit(JModelConfig(**TINY_KW))(
            flax_params, jnp.asarray(roll), jnp.asarray(onoff), spec[idx],
            jnp.asarray(starts, jnp.int32), jnp.asarray(valid), jnp.int32(t_total), l_out=l_out)
        mag = jnp.sqrt(jnp.expm1(jnp.clip(pred.T, 0.0, 20.0)))
        want = np.asarray(jgl.griffinlim(mag, n_iter=SERVE_ITERS,
                                         init_phase=jnp.asarray(phase.numpy()),
                                         use_pallas_glue=False, transform="fft"))
        with torch.inference_mode():
            got = programs["serving"].module()(*_program_args(params, *inputs))
        assert got.shape == want.shape == (256 * (l_out - 1),)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * np.abs(want).max())

    def test_blend_equals_the_serving_path(self):
        """The blend that the serving path and the program share (tile
        starts as a tensor, ``t_total`` an int or a 0-d tensor) adds the
        same products in the same order as a plain crossfade of slice adds:
        bit-equal."""
        from ml_music_style_transfer_tpu_torch.infer.synthesize import _blend

        rng = np.random.default_rng(7)
        win = 860
        pred = torch.from_numpy(rng.random((4, win, 9), dtype=np.float32))
        starts, valid = [0, 430, 700, 0], [1.0, 1.0, 1.0, 0.0]
        j = torch.arange(win, dtype=torch.float32)
        wgt = torch.minimum(j + 1.0, win - j)[:, None]
        num, den = torch.zeros((1720, 9)), torch.zeros((1720, 1))
        for p, s, v in zip(pred, starts, valid):
            num[s : s + win] += p * wgt * v
            den[s : s + win] += wgt * v
        want = num / torch.clamp(den, min=1e-9)
        want[1500:] = 0.0
        for t_total in (1500, torch.tensor(1500)):
            got = _blend(pred, torch.tensor(starts), torch.tensor(valid), t_total, 1720)
            assert torch.equal(got, want)


class TestFreshProcess:
    def test_programs_load_and_run_in_a_fresh_process(self, programs, params, tmp_path):
        """A new interpreter imports the package (which registers the
        mmst_torch operators the programs name), loads the three files and
        runs each: the same outputs as in this process, bit for bit."""
        rng = np.random.default_rng(2)
        spec = torch.from_numpy(_log_spec(rng, GL_FRAMES))
        inputs = {
            "forward": (params, torch.from_numpy((rng.random((1, T, 128)) < 0.05).astype(
                np.float32)), torch.from_numpy(rng.random((1, T, 1025), dtype=np.float32) * 8),
                torch.from_numpy(rng.integers(-1, 2, (1, T, 128)).astype(np.float32))),
            "griffinlim": (spec, program_export.init_phase(spec.shape, 4),
                           program_export.iterations(GL_ITERS)),
            "serving": _program_args(params, *_serving_inputs()),
        }
        torch.save(inputs, tmp_path / "in.pt")
        code = ("import sys, torch\nimport ml_music_style_transfer_tpu_torch\n"
                "from ml_music_style_transfer_tpu_torch.compat.program_export import load_artifact\n"
                "torch.set_num_threads(2)\n"
                "inputs = torch.load(sys.argv[2])\n"
                "with torch.inference_mode():\n"
                "    out = {k: load_artifact(f'{sys.argv[1]}/{k}.pt2').module()(*v)\n"
                "           for k, v in inputs.items()}\n"
                "torch.save(out, sys.argv[3])\n")
        env = dict(os.environ, PYTHONPATH=ROOT)
        subprocess.run([sys.executable, "-c", code, str(programs["dir"]), str(tmp_path / "in.pt"),
                        str(tmp_path / "out.pt")], check=True, env=env, timeout=300)
        got = torch.load(tmp_path / "out.pt")
        with torch.inference_mode():
            for name, args in inputs.items():
                assert torch.equal(got[name], programs[name].module()(*args)), name


class TestEntryPoints:
    def test_export_program_writes_programs_and_manifest(self, tmp_path, capsys):
        paths = export_program.main(["--out", str(tmp_path), "--width-mult", "0.0625",
                                     "--t", str(T), "--frames", "32",
                                     "--serving-n-tiles", "0", "--device", "cpu"])
        assert set(paths) == {"forward", "griffinlim", "manifest"}
        manifest = json.loads((tmp_path / "manifest.json").read_text())
        assert manifest["device"] == "cpu" and manifest["transform"] == "fft"
        assert manifest["forward"]["t"] == T and manifest["griffinlim"] == {
            "frames": 32, "inputs": ["spec", "init_phase", "n_iter"]}
        assert "serving" not in manifest and set(manifest["export_seconds"]) == {
            "forward", "griffinlim"}
        assert "exported in" in capsys.readouterr().out
        ep = program_export.load_artifact(paths["griffinlim"])
        spec = torch.from_numpy(_log_spec(np.random.default_rng(8), 32))
        assert ep.module()(spec, program_export.init_phase(spec.shape),
                           program_export.iterations(2)).shape == (256 * 31,)

    def test_default_device_raises_without_a_card(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            program_export.export_griffinlim(frames=32)
