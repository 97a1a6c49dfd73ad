"""The port's support code on the CPU: the kernels' ``mmst_torch`` operators
(``csrc/mmst_ops.cpp``, wrapped in ``ops/kernels/gl_glue.py``, ``dropout.py``), profiling and NaN debugging
(``utils/profiling.py``), the reference ``.tar`` writer and its script
against the JAX package's (``compat/torch_export.py``,
``scripts/export_torch_checkpoint.py``), and ``plot_spec``'s panels against
the JAX package's NumPy references. Width 1/16, float32."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.compat import torch_export as jtorch_export
from ml_music_style_transfer_tpu.config import DEFAULT_DSP as JDSP
from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
from ml_music_style_transfer_tpu.ops import reference as jnpref
from ml_music_style_transfer_tpu_torch.compat import weights
from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.data import audio_io
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import kernels
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as dk
from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue
from ml_music_style_transfer_tpu_torch.scripts import export_torch_checkpoint
from ml_music_style_transfer_tpu_torch.testing import plot_spec
from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
from ml_music_style_transfer_tpu_torch.train.loop import Trainer
from ml_music_style_transfer_tpu_torch.utils import profiling

TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32")
T = 220
SEED_HIGH = 0x9E3779B97F4A7C15  # above 2^63: crosses the int64 schema as a negative


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads per module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _glue_inputs(nf=30, seed=0):
    gen = torch.Generator().manual_seed(seed)
    cpu = torch.device("cpu")
    frames = torch.randn((nf, 2048), generator=gen)
    window = tstft.window_tensor(2048, 2048, cpu)
    inv = tstft.wss_inv_tensor(2048, 2048, 256, nf, cpu).view(nf + 7, 256)
    return frames, window, inv


class TestOperators:
    @pytest.mark.parametrize("case", ["gl_ola_nola", "gl_frame_window", "dropout_apply",
                                      "dropout_apply_backward"])
    def test_opcheck(self, case):
        """Schema, fake (shapes), autograd registration and dispatch of the
        operators, defined in C++ and loaded by ``ops()``."""
        frames, window, inv = _glue_inputs()
        ops = kernels.ops()
        if case == "gl_ola_nola":
            torch.library.opcheck(ops.gl_ola_nola.default, (frames, window, inv))
        elif case == "gl_frame_window":
            y = gl_glue.ola_nola(frames, window, inv)
            torch.library.opcheck(ops.gl_frame_window.default, (y, window, 30))
        else:
            x = torch.randn(2, 6, 10, requires_grad=case == "dropout_apply")
            torch.library.opcheck(ops.dropout_apply.default,
                                  (x, -5, 3, 0.2, case == "dropout_apply_backward"))

    def test_glue_through_the_operators_equals_the_wrappers(self):
        """Watched by a dispatch mode, ``gl_consistency_frames`` runs the
        two operators, once each, and equals the two wrappers called
        directly."""
        frames, window, inv = _glue_inputs(48, 1)
        want = gl_glue.frame_window(gl_glue.ola_nola(frames, window, inv), window, 48)
        with profiling.NanCheckMode() as mode:
            got = gl_glue.gl_consistency_frames(frames, window, inv)
        assert mode.seen == {"mmst_torch.gl_ola_nola.default": 1,
                             "mmst_torch.gl_frame_window.default": 1}
        assert torch.equal(got, want)

    def test_griffinlim_takes_the_operators_only_when_watched(self):
        """Griffin-Lim's glue is the two operators, one of each per
        iteration, under a dispatch mode and in plain eager code alike (here
        under the profiler, which records operator calls but is no dispatch
        mode): the C++ operators are the one route, watched or not, and the
        result is the same."""
        mag = torch.rand((1025, 30), generator=torch.Generator().manual_seed(3))
        phase = 2 * np.pi * torch.rand(mag.shape, generator=torch.Generator().manual_seed(4))
        with profiling.NanCheckMode() as mode:
            watched = tgl.griffinlim(mag, n_iter=3, init_phase=phase, device="cpu")
        assert mode.seen["mmst_torch.gl_ola_nola.default"] == 3
        assert mode.seen["mmst_torch.gl_frame_window.default"] == 3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            plain = tgl.griffinlim(mag, n_iter=3, init_phase=phase, device="cpu")
        counts = {e.key: e.count for e in prof.key_averages()}
        assert "aten::fft_irfft" in counts
        assert counts["mmst_torch::gl_ola_nola"] == counts["mmst_torch::gl_frame_window"] == 3
        assert torch.equal(plain, watched)

    @pytest.mark.parametrize("seed", [7, SEED_HIGH])
    def test_dropout_through_the_operator_equals_dropout_function(self, seed):
        """``dropout`` (the operator, seeds above 2^63 included) against the
        wrappers: forward ``dropout_apply``, gradient ``dropout_grad``."""
        x = torch.randn(2, 12, 30, requires_grad=True)
        g = torch.randn(2, 12, 30)
        got = dk.dropout(x, seed, 3, 0.2)
        assert torch.equal(got, dk.dropout_apply(x.detach(), seed, 3, 0.2))
        assert torch.equal(torch.autograd.grad(got, x, g)[0], dk.dropout_grad(g, seed, 3, 0.2))


class TestProfiling:
    def test_device_trace_names_the_span(self, tmp_path):
        with profiling.device_trace(str(tmp_path / "trace")) as prof:
            with profiling.span("mmst.test_span"):
                torch.randn(100).sum()
        events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
        assert any(e.get("name") == "mmst.test_span" for e in events)
        assert any(e.key == "mmst.test_span" for e in prof.key_averages())

    def test_compile_cache_builds_nothing_on_the_cpu(self, monkeypatch):
        assert profiling.enable_persistent_compile_cache("cpu") is None
        monkeypatch.setenv("MMST_COMPILE_CACHE", "0")
        assert profiling.enable_persistent_compile_cache() is None
        monkeypatch.delenv("MMST_COMPILE_CACHE")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.enable_persistent_compile_cache()


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return {"midi": f(rng.random((b, T, 128)) < 0.05), "cond": f(rng.random((b, T, 1025)) * 8),
            "onoff": f(rng.integers(-1, 2, (b, T, 128))), "target": f(rng.random((b, T, 1025)) * 8),
            "weight": torch.ones(b)}


class TestNanDebugging:
    def test_raises_naming_the_operator(self):
        x = torch.tensor([1.0, float("nan")])
        with pytest.raises(FloatingPointError, match=r"aten\.mul"):
            with profiling.nan_debugging():
                x * 2.0
        assert not torch.is_anomaly_enabled()

    def test_allocations_are_not_flagged(self):
        with profiling.nan_debugging() as mode:
            x = torch.empty(4096)
            torch.empty_like(x)
            x.new_empty((64,))
            torch.empty_strided((8, 8), (1, 8))
        assert mode.seen["aten.empty.memory_format"] >= 1

    def test_enable_returns_a_context_that_leaves(self):
        ctx = profiling.enable_nan_debugging()
        try:
            assert torch.is_anomaly_enabled()
            with pytest.raises(FloatingPointError):
                torch.tensor([float("nan")]) * 1.0
        finally:
            ctx.__exit__(None, None, None)
        assert not torch.is_anomaly_enabled()
        torch.tensor([float("nan")]) * 1.0

    def test_clean_train_step_gives_the_same_loss(self):
        """Same weights, batch and dropout seed with and without the mode:
        no false positive, the same loss and weights after the update, and
        the mode sees the dropout kernel's 10 + 10 calls as its operator."""
        runs = []
        for debug in (False, True):
            tr = Trainer(ModelConfig(**TINY_KW), TrainConfig(batch_size=2), device="cpu")
            tr.init_state(0)
            if debug:
                with profiling.nan_debugging() as mode:
                    loss = float(tr.train_step(_batch(), SEED_HIGH))
                assert mode.seen["mmst_torch.dropout_apply.default"] == 20
            else:
                loss = float(tr.train_step(_batch(), SEED_HIGH))
            runs.append((loss, [p.detach().clone() for p in tr.model.parameters()]))
        assert runs[0][0] == runs[1][0]
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

    def test_nan_in_a_batch_raises(self):
        tr = Trainer(ModelConfig(**TINY_KW), TrainConfig(batch_size=2), device="cpu")
        tr.init_state(0)
        bad = _batch(1)
        bad["cond"][1, 50, 3] = float("nan")
        with pytest.raises(FloatingPointError, match=r"NaN in the output of aten\."):
            with profiling.nan_debugging():
                tr.train_step(bad, 1)


@pytest.fixture(scope="module")
def flax_params():
    model = JPerformanceNet(JModelConfig(**TINY_KW))
    z = jnp.zeros((1, T, 128))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), z, jnp.zeros((1, T, 1025)), z)
    return jax.tree_util.tree_map(np.asarray, params)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _assert_same_tar(got_path, want_path):
    got = torch.load(got_path, weights_only=True)
    want = torch.load(want_path, weights_only=True)
    assert set(got) == set(want) == {"epoch", "state_dict", "optimizer"}
    assert got["epoch"] == want["epoch"] and got["optimizer"] is want["optimizer"] is None
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for k, v in want["state_dict"].items():
        g = got["state_dict"][k]
        assert g.dtype == v.dtype == torch.float32 and g.is_contiguous() and torch.equal(g, v), k


class TestReferenceCheckpoint:
    @pytest.mark.parametrize("source", ["flax_tree", "port_state_dict"])
    def test_equals_the_jax_writer(self, tmp_path, flax_params, source):
        jtorch_export.save_reference_checkpoint(str(tmp_path / "jax.tar"), flax_params, epoch=7)
        params = flax_params if source == "flax_tree" else weights.from_jax_params(flax_params)
        weights.save_reference_checkpoint(str(tmp_path / "port.tar"), params, epoch=7)
        _assert_same_tar(tmp_path / "port.tar", tmp_path / "jax.tar")
        back = weights.load_reference_checkpoint(str(tmp_path / "port.tar"))
        want = weights.from_jax_params(flax_params)
        assert sorted(back) == sorted(want) and all(torch.equal(back[k], want[k]) for k in want)

    def test_unmapped_key_raises(self, tmp_path, flax_params):
        state = weights.from_jax_params(flax_params)
        state["not_a_module.weight"] = torch.zeros(3)
        with pytest.raises(KeyError, match="not_a_module"):
            weights.save_reference_checkpoint(str(tmp_path / "x.tar"), state)
        assert not os.path.exists(tmp_path / "x.tar")


class TestExportTorchCheckpoint:
    @pytest.mark.parametrize("fmt", ["torch", "msgpack"])
    @pytest.mark.parametrize("use_ema", [False, True])
    def test_experiment_to_tar(self, tmp_path, flax_params, fmt, use_ema):
        """A port ``.pt`` or a JAX-layout ``.msgpack`` experiment (its
        ``params`` and ``ema_params``), best epoch from hyperparams.json,
        exported equal to the JAX package's writer on the same tree."""
        params = weights.from_jax_params(flax_params)
        gen = torch.Generator().manual_seed(3)
        ema = {k: v + 0.01 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
        exp = tmp_path / "experiments" / "e"
        exp.mkdir(parents=True)
        state = {"params": params, "ema_params": ema, "epoch": 2}
        if fmt == "msgpack":
            state = {"params": weights.to_jax_params(params),
                     "ema_params": weights.to_jax_params(ema), "epoch": 2}
        ckpt.save_checkpoint(str(exp), 2, state, fmt=fmt)
        (exp / "hyperparams.json").write_text(json.dumps({"best_epoch": 2}))
        argv = ["-exp-name", "e", "--exp-root", str(tmp_path / "experiments"), "--device", "cpu"]
        out = export_torch_checkpoint.main(argv + (["--use-ema"] if use_ema else []))
        assert out == str(exp / "checkpoint-2.tar")
        tree = _numpy_tree(weights.to_jax_params(ema if use_ema else params))
        jtorch_export.save_reference_checkpoint(str(tmp_path / "want.tar"), tree, epoch=2)
        _assert_same_tar(out, tmp_path / "want.tar")

    def test_named_epoch_and_missing_checkpoint(self, tmp_path, flax_params):
        exp = tmp_path / "experiments" / "e"
        exp.mkdir(parents=True)
        ckpt.save_checkpoint(str(exp), 4, {"params": weights.from_jax_params(flax_params)})
        root = ["-exp-name", "e", "--exp-root", str(tmp_path / "experiments")]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_torch_checkpoint.main(root + ["--epoch", "4"])
        root += ["--device", "cpu"]
        out = export_torch_checkpoint.main(root + ["--epoch", "4", "--out", str(tmp_path / "o.tar")])
        assert torch.load(out, weights_only=True)["epoch"] == 4
        with pytest.raises(FileNotFoundError, match="checkpoint-5"):
            export_torch_checkpoint.main(root + ["--epoch", "5"])
        with pytest.raises(ValueError, match="ema_params"):
            export_torch_checkpoint.main(root + ["--epoch", "4", "--use-ema"])

    @staticmethod
    def _jax_script():
        """The JAX package's ``scripts/export_torch_checkpoint.py`` as a module."""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "jax_export_torch_checkpoint",
            os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                         "export_torch_checkpoint.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    @staticmethod
    def _experiment(root, name: str):
        exp = root / "experiments" / name
        exp.mkdir(parents=True)
        (exp / "hyperparams.json").write_text(json.dumps(
            {"train_epoch": 1, "test_freq": 1, "exp_name": name, "best_epoch": 1}))
        return exp

    def test_width_mult_as_the_jax_script(self, tmp_path, flax_params):
        """``--width-mult`` against the JAX script on the same files. A width
        1/16 ``.msgpack`` under ``--width-mult 0.125``: flax's template
        checks keys, not shapes, so both export it, equal. The same file
        without the last layer (``lastconv``): both refuse (the port names
        the key). An
        ``.orbax`` (the committed JAX-written fixture) under another width:
        both export it, equal, without a template."""
        jscript = self._jax_script()
        params = weights.from_jax_params(flax_params)
        cases = {"w": params, "headless": {k: v for k, v in params.items()
                                           if not k.startswith("lastconv.")}}
        assert len(cases["headless"]) == len(params) - 2
        for name, state in cases.items():
            exp = self._experiment(tmp_path, name)
            ckpt.save_checkpoint(str(exp), 1, {"params": weights.to_jax_params(state),
                                               "epoch": 1}, fmt="msgpack")
        root = ["--exp-root", str(tmp_path / "experiments"), "--width-mult", "0.125"]
        port = export_torch_checkpoint.main(["-exp-name", "w", "--device", "cpu", "--out",
                                             str(tmp_path / "port.tar")] + root)
        jscript.main(["-exp-name", "w", "--out", str(tmp_path / "jax.tar")] + root)
        _assert_same_tar(port, tmp_path / "jax.tar")
        with pytest.raises(ValueError, match="lastconv"):
            jscript.main(["-exp-name", "headless"] + root)
        with pytest.raises(ValueError, match="no 'lastconv.weight'.* width_mult 0.125"):
            export_torch_checkpoint.main(["-exp-name", "headless", "--device", "cpu"] + root)

        from ml_music_style_transfer_tpu.train import checkpoint as jckpt
        exp = self._experiment(tmp_path, "orbax")
        jckpt.save_checkpoint_sharded(str(exp), 1, {"params": flax_params, "epoch": 1}, wait=True)
        root = ["-exp-name", "orbax", "--exp-root", str(tmp_path / "experiments"),
                "--width-mult", "0.5"]
        port = export_torch_checkpoint.main(root + ["--device", "cpu", "--out",
                                                    str(tmp_path / "port_o.tar")])
        jscript.main(root + ["--out", str(tmp_path / "jax_o.tar")])
        _assert_same_tar(port, tmp_path / "jax_o.tar")


class TestPlotSpec:
    def test_panels_equal_the_jax_references(self):
        rng = np.random.default_rng(9)
        y = (0.3 * rng.standard_normal(JDSP.samples_per_chunk + 5000)).astype(np.float32)
        chunk = y[: JDSP.samples_per_chunk]
        mag = np.abs(jnpref.stft(chunk, JDSP.n_fft, JDSP.ws))
        want = [np.log1p(mag**2), mag,
                np.log1p(jnpref.mel_filterbank(JDSP.sr, JDSP.n_fft, 128) @ (mag**2))]
        got = plot_spec.spec_panels(y)
        assert [g.shape for g in got] == [(1025, 860), (1025, 860), (128, 860)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)

    def test_writes_a_png(self, tmp_path):
        wav = str(tmp_path / "a.wav")
        t = np.arange(3 * 44100) / 44100
        audio_io.write_wav(wav, (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), 44100)
        out = plot_spec.plot_spec(wav, str(tmp_path / "a.png"))
        with open(out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    def test_without_matplotlib_raises_import_error(self, tmp_path, monkeypatch):
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="spec_panels"):
            plot_spec.plot_spec(str(tmp_path / "none.wav"))
