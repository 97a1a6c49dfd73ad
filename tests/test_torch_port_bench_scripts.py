"""The port's bench scripts (``scripts/bench_inference.py``'s whole-clip
section, ``bench_preprocess.py``, ``bench_dft_gl.py``,
``bench_gl_kernels.py``) and ``real_data_check.py --workdir`` run end to
end on the CPU (``--device cpu``) at tiny sizes. Their times are the host
clock's and are not checked; what is checked is that every part ran, that
the JSON each writes carries the keys of the JAX package's artifact
(``SERVING_WHOLECLIP.json``, ``PREPROCESS_BENCH.json`` at the root), and
the content checks each makes.
"""
import json
import math
import os

import h5py
import pytest
import torch

from ml_music_style_transfer_tpu_torch.scripts import (bench_dft_gl, bench_gl_kernels,
                                                       bench_inference, bench_preprocess,
                                                       real_data_check)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_artifact(name: str) -> dict:
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def _has_keys_of(got: dict, want: dict, path: str = "") -> None:
    """Every key of ``want`` is in ``got``, nested dicts alike."""
    for k, v in want.items():
        assert k in got, f"{path}{k}"
        if isinstance(v, dict):
            _has_keys_of(got[k], v, f"{path}{k}.")


def test_bench_inference_whole_clip_section(tmp_path, capsys, monkeypatch):
    """Width 1/16, a 10 s clip, the probe capped at 60 s (2 Griffin-Lim
    iterations a probe clip instead of 30, the CPU's time): the whole-clip
    JSON has the JAX artifact's keys, the divergence is finite, the 60 s
    clip served, and the profile was written."""
    monkeypatch.setattr(bench_inference, "PROBE_N_ITER", 2)
    metrics = bench_inference.main([
        "--device", "cpu", "--width-mult", "0.0625", "--seconds", "10", "--n-iter", "1",
        "--daemon-requests", "0", "--probe-cap-seconds", "60", "--out-dir", str(tmp_path),
        "--profile-dir", str(tmp_path / "profile")])
    out = capsys.readouterr().out
    assert set(metrics) == {"serving_s_per_30s_clip", "griffinlim_s_per_10s_clip",
                            "whole_clip_s_per_30s_clip", "batch_griffinlim_s_per_clip"}
    wc = json.loads((tmp_path / "SERVING_WHOLECLIP_CPU_W0p0625.json").read_text())
    _has_keys_of(wc, _jax_artifact("SERVING_WHOLECLIP.json"))
    assert wc["device"] == "cpu" and wc["width_mult"] == 0.0625
    assert wc["steady_s"] == metrics["whole_clip_s_per_30s_clip"]
    assert wc["tiled_steady_s"] == metrics["serving_s_per_30s_clip"]
    d = wc["divergence"]
    assert d["t_frames_compared"] > 1700 and d["interior_margin_frames"] == d[
        "t_frames_compared"] // 4
    assert all(math.isfinite(d[k]) and d[k] >= 0 for k in
               ("rel_l2", "interior_rel_l2", "mean_abs", "spec_mean_abs_level"))
    probe = wc["max_onepass_probe"]
    assert probe["longest_ok_s"] == 60.0 and probe["first_fail_s"] is None
    assert probe["n_iter"] == 2 and probe["cap_s"] == 60.0
    assert set(probe["seconds"]) == {"60"}
    assert "[whole-clip] " + json.dumps(wc) in out
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0


def test_bench_preprocess_keys_and_content(tmp_path, capsys):
    out = tmp_path / "pp.json"
    got = bench_preprocess.main(["--device", "cpu", "--songs", "1", "--duration", "10",
                                 "--styles", "cuba", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    _has_keys_of(got, _jax_artifact("PREPROCESS_BENCH.json"))
    assert got["sink"] == "memory" and got["device"] == "cpu"
    assert got["n_chunks"] == 1 and got["frames_total"] == 860
    assert got["auto_resolved_backend"] == "device"  # on the CPU, with no probe
    assert got["spec_max_abs_diff"] < 1e-3  # the log-power STFT's contract
    assert all(got[k] > 0 for k in got if k.endswith("_s"))


def test_bench_dft_gl_variants(tmp_path):
    out = tmp_path / "dft.json"
    got = bench_dft_gl.main(["--device", "cpu", "--seconds", "0.3", "--n-iter", "4",
                             "--json-out", str(out)])
    assert json.loads(out.read_text()) == got
    assert got["n_frames"] == 1 + int(0.3 * 44100) // 256
    errs = {v: got[v]["spectral_err"] for v in ("fft", "dft_bf16", "dft_tf32", "dft_f32")}
    assert all(0 < e < 1 for e in errs.values())
    # float32 matmuls round as the FFTs do; bfloat16 inputs cost at most 1 %
    assert all(abs(errs[v] - errs["fft"]) < 1e-4 for v in ("dft_f32", "dft_tf32"))
    assert abs(errs["dft_bf16"] - errs["fft"]) < 1e-2


def test_bench_gl_kernels(tmp_path):
    out = tmp_path / "k.json"
    got = bench_gl_kernels.main(["--device", "cpu", "--batch", "1", "--n-iter", "2",
                                 "--frames", "48", "--json-out", str(out)])
    assert json.loads(out.read_text()) == got
    gl = got["griffinlim"]
    assert gl["frames"] == 48 and gl["glue_s"] > 0 and gl["plain_loop_s"] > 0
    assert gl["waveform_rel_diff"] < 1e-4  # two float32 paths, 2 iterations
    shapes = [tuple(r["shape"]) for r in got["dropout"]]
    assert shapes == bench_gl_kernels.dense_concat_shapes(1) and len(shapes) == 10
    assert all(r["mask_bit_equal_to_plain"] for r in got["dropout"])


def test_real_data_check_workdir_writes_and_reads_hdf5(tmp_path, capsys):
    work = tmp_path / "work"
    got = real_data_check.main(["--synthetic", "--device", "cpu", "--width-mult", "0.0625",
                                "--steps", "3", "--batch-size", "2", "--n-iter", "2",
                                "--workdir", str(work)])
    assert got["dataset"] == str(work / "ds_train.hdf5") and got["passed"]
    with h5py.File(got["dataset"], "r") as f:
        assert f["pianoroll"].shape[0] == got["n_chunks"] == 6
        assert {"spec_cuba", "spec_upright"} <= set(f.keys())
    assert (work / "songs").is_dir()  # the directory is kept


def test_real_data_check_workdir_needs_h5py(tmp_path, monkeypatch):
    real = real_data_check.importlib.util.find_spec
    monkeypatch.setattr(real_data_check.importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    with pytest.raises(ImportError, match="h5py"):
        real_data_check.main(["--synthetic", "--device", "cpu", "--workdir", str(tmp_path)])
