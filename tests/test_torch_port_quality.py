"""The port's quality measure against the JAX package's
(``testing/quality.py``; NumPy on both sides, so equal), and smoke runs of
the port's quality gate and train-step bench on the CPU at width 1/16
(their numbers count only on the card)."""
import glob
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from ml_music_style_transfer_tpu.testing import quality as jquality
from ml_music_style_transfer_tpu_torch.scripts import bench_train, quality_gate
from ml_music_style_transfer_tpu_torch.testing import quality

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads per module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _matrices(n, seed):
    rng = np.random.default_rng(seed)
    sep = rng.uniform(0.02, 0.1, (n, n))
    sep = (sep + sep.T) / 2
    np.fill_diagonal(sep, 0.0)
    conf = rng.uniform(0.01, 0.12, (n, n))
    return conf, sep


class TestQuality:
    @pytest.mark.parametrize("n,seed", [(2, 0), (2, 1), (5, 2), (5, 3)])
    @pytest.mark.parametrize("alpha", [0.25, 0.0, 0.9])
    def test_report_equals_jax(self, n, seed, alpha):
        conf, sep = _matrices(n, seed)
        np.testing.assert_array_equal(quality.normalized_margins(conf, sep),
                                      jquality.normalized_margins(conf, sep))
        assert (quality.discrimination_report(conf, sep, alpha)
                == jquality.discrimination_report(conf, sep, alpha))

    def test_zero_separation_and_bad_shapes(self):
        conf, sep = _matrices(3, 4)
        sep[0, 1] = 0.0
        got = quality.normalized_margins(conf, sep)
        assert got[0, 1] == -np.inf and np.isinf(got[1, 1])
        assert not quality.discrimination_report(conf, sep)["passed"]
        with pytest.raises(ValueError, match="square"):
            quality.normalized_margins(conf, sep[:2])
        assert quality.DEFAULT_ALPHA == jquality.DEFAULT_ALPHA == 0.25


def _tpu_artifacts():
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in glob.glob(os.path.join(ROOT, "QUALITY_GATE_TPU*.json"))}


class TestQualityGate:
    def test_smoke_on_the_cpu(self, tmp_path, capsys):
        before = _tpu_artifacts()
        result = quality_gate.main(["--device", "cpu", "--width-mult", "0.0625", "--epochs", "1",
                                    "--batch-size", "4", "--out-dir", str(tmp_path)])
        assert _tpu_artifacts() == before
        written = json.loads((tmp_path / "QUALITY_GATE_CPU_W0p0625.json").read_text())
        assert written == json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
        assert result["styles"] == ["gentleman", "harpsichord"] and result["n_chunks"] == 30
        assert result["steps"] == 7 and result["device"]["kind"] == "cpu"
        assert np.array(result["l1_confusion"]).shape == (2, 2)
        assert np.allclose(np.diag(result["l1_target_separation"]), 0.0)
        assert result["gl_finite"] and result["gl_iters"] == 100
        assert isinstance(result["passed"], bool) and result["alpha"] == 0.25

    def test_names_and_refusals(self):
        def name(*argv, device="cuda"):
            return quality_gate.artifact_name(quality_gate.build_argparser().parse_args(list(argv)),
                                              torch.device(device))

        assert name() == "QUALITY_GATE_H100.json"
        assert name("--styles", "5", "--seed", "1") == "QUALITY_GATE_H100_5STYLE_SEED1.json"
        assert name("--width-mult", "0.5", device="cpu") == "QUALITY_GATE_CPU_W0p5.json"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quality_gate.main(["--epochs", "1"])
        for flags in (["--spectral-loss-weight", "0.1"], ["--wholeclip-divergence"]):
            with pytest.raises(NotImplementedError, match="item 10"):
                quality_gate.main(flags + ["--device", "cpu"])


class TestBenchTrain:
    @pytest.mark.parametrize("data", ["host", "resident"])
    def test_smoke_on_the_cpu(self, data, capsys):
        metrics = bench_train.main(["--device", "cpu", "--batch-size", "2", "--epochs", "1",
                                    "--data", data])
        assert set(metrics) == {"train_step_spectrogram_frames_per_sec_per_chip", "train_step_s",
                                "preprocess_frames_per_sec"}
        assert metrics["train_step_spectrogram_frames_per_sec_per_chip"] == pytest.approx(
            2 * 860 / metrics["train_step_s"])
        out = capsys.readouterr().out
        assert f"data={data}" in out and "device='cpu'" in out and "width_mult=0.0625" in out

    def test_default_device_raises(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_train.main([])
