"""The port's profile and real-data scripts (``scripts/profile_step.py``,
``profile_gl.py``, ``real_data_check.py``) run end to end on the CPU
(``--device cpu``) at width 1/16 with small iteration counts, and their
output lines parse: each ``metric`` line names a time in milliseconds, and
the last line is the JSON object that ``main`` returns. The times are the
host clock's and are not checked; what is checked is that every phase ran
and reported a finite, positive time (the Griffin-Lim remainder may be
negative on the host clock's noise).
"""
import json
import math
import re

import pytest
import torch

from ml_music_style_transfer_tpu_torch.scripts import profile_gl, profile_step, real_data_check

METRIC = re.compile(r"^metric (\w+)=(\S+) ms device='cpu'(.*)$")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _metric_lines(out: str) -> dict:
    lines = out.strip().splitlines()
    metrics = {}
    for line in lines[:-1]:
        m = METRIC.match(line)
        assert m, line
        metrics[m.group(1)] = float(m.group(2))
    tail = json.loads(lines[-1])
    assert tail["device"] == "cpu" and tail["kind"] == "cpu"
    assert set(tail["metrics"]) == set(metrics)
    for k, v in metrics.items():
        assert math.isclose(tail["metrics"][k], v, rel_tol=1e-5), k
    return metrics


def test_profile_step_reports_each_phase_and_subsystem(capsys):
    got = profile_step.main(["--device", "cpu", "--width-mult", "0.0625", "--batch-size", "2",
                             "--frames", "220", "--n-iter", "1", "--warmup", "0"])
    metrics = _metric_lines(capsys.readouterr().out)
    assert metrics.keys() == got.keys() == {
        "forward_ms", "forward_backward_ms", "full_update_ms", "forward_encoders_ms",
        "forward_dense_fusions_ms", "forward_decoder_ms", "forward_mbr_and_head_ms"}
    assert all(v > 0 and math.isfinite(v) for v in metrics.values())


def test_profile_gl_reports_the_iteration_and_its_parts(capsys):
    got = profile_gl.main(["--device", "cpu", "--frames", "215", "--n-iter", "2",
                           "--warmup", "1"])
    metrics = _metric_lines(capsys.readouterr().out)
    parts = ("irfft", "rfft", "glue", "momentum_elementwise")
    assert metrics.keys() == got.keys() == {
        "gl_iteration_ms", "gl_rest_ms", *(f"gl_{p}_ms" for p in parts)}
    assert all(metrics[f"gl_{p}_ms"] > 0 for p in parts) and metrics["gl_iteration_ms"] > 0
    # the remainder from the unrounded times (the lines print 6 digits)
    assert math.isclose(got["gl_rest_ms"],
                        got["gl_iteration_ms"] - sum(got[f"gl_{p}_ms"] for p in parts),
                        rel_tol=1e-9, abs_tol=1e-12)


def test_real_data_check_on_a_synthetic_directory(tmp_path, capsys):
    out = tmp_path / "report.json"
    got = real_data_check.main(["--synthetic", "--device", "cpu", "--width-mult", "0.0625",
                                "--steps", "3", "--batch-size", "2", "--n-iter", "2",
                                "--out", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got == json.loads(out.read_text())
    assert not got["skipped"] and got["n_chunks"] == 6 and got["styles"] == ["cuba", "upright"]
    assert got["synth_finite"] and math.isfinite(got["gl_rel_err"])
    assert got["train_l1_last"] < got["train_l1_first"] and got["passed"]


def test_real_data_check_skips_without_data(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("MMST_REAL_DATA_DIR", raising=False)
    got = real_data_check.main(["--device", "cpu"])
    assert got["skipped"] and json.loads(capsys.readouterr().out) == got
    got = real_data_check.main(["--device", "cpu", "--data-dir", str(tmp_path)])
    assert got["skipped"] and "mixcraft" in got["reason"]
