"""The port's daemon soak (``scripts/soak_daemon.py``) end to end on the
CPU at width 1/16 with 2 Griffin-Lim iterations: 25 mixed requests through
``serve_loop`` after its warm pass. Its latencies are host-clock numbers of
a shared CPU, so the timing probe is recorded, not held, here; the card
runs it at full width (``chip_smoke.py`` phase 19)."""
import json

import pytest
import torch

from ml_music_style_transfer_tpu_torch.scripts import soak_daemon


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads per module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    out = tmp_path_factory.mktemp("soak") / "DAEMON_SOAK_CPU.json"
    result = soak_daemon.main(["--device", "cpu", "--width-mult", "0.0625", "--n-iter", "2",
                               "--requests", "25", "--out", str(out)])
    return result, json.loads(out.read_text())


def test_isolation_and_no_cache_warning(soak):
    result, written = soak
    assert written == json.loads(json.dumps(result))
    assert result["isolation_violations"] == 0 and result["cache_warnings"] == 0
    assert result["ok"] == result["expected_ok"] == 21 and result["bad_requests"] == 4
    assert result["wavs_checked"] == 23  # 17 single-clip requests + 2 batches of two + 2 whole


def test_every_class_present(soak):
    result, _ = soak
    assert set(result["latency_s"]) == {"single_a", "single_b", "single_c", "novel", "batch",
                                        "whole", "bad"}
    assert sum(v["n"] for v in result["latency_s"].values()) == 25


def test_json_fields(soak):
    result, _ = soak
    for key in ("requests", "wall_s", "requests_per_s", "warm_s", "n_iter", "pipeline_depth",
                "bad_kinds", "novel_probe", "griffinlim_runs", "glue_launches",
                "peak_memory_GB", "device", "width_mult"):
        assert key in result, key
    assert result["device"] == {"kind": "cpu", "name_power_limit": None}
    assert result["peak_memory_GB"] == "not measured"
    for v in result["latency_s"].values():
        assert v["p50"] <= v["p90"] <= v["p99"]
    probe = result["novel_probe"]
    assert len(probe["bucket_s"]) == soak_daemon.PROBE_REPEATS and probe["novel_first_s"] > 0
    assert probe["bucket_p50_s"] <= probe["bucket_p90_s"]
    # 6 warm, 16 + 1 probe, 17 single-clip, 2 x 2 batch and 2 whole-clip
    # requests (the first 4 malformed kinds make none; the fifth, an
    # unwritable output, first comes at request 31)
    assert result["griffinlim_runs"] == 6 + 17 + 17 + 4 + 2


def test_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak_daemon.main(["--requests", "1"])
