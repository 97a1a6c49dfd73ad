"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``."""
import os
import sys

import pytest
import torch

# Parallel test workers share the cores: one intra-op thread each keeps a
# tiny step near its time alone (with every worker's default pool, steps
# took a hundred times as long and a window held a single step).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The serving driver and its traffic file are kept for a cell that
# BENCHMARK.json does not hold yet; the tests add that cell as data.
SERVING = {
    "workloads": [{"name": "pnet-serve-backlog", "config": "performancenet",
                   "traffic": "serve_backlog", "chips": 1, "why": "serving test cell"}],
    "end_to_end": [{"name": "serve_audio_s_per_s", "unit": "audio-s/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": ["pnet-serve-backlog"]}],
    "per_layer": [{"name": "serve.mfu", "unit": "%", "better": "higher", "source": "host_clock",
                   "layer": "whole request", "moves": "serve_audio_s_per_s",
                   "workloads": ["pnet-serve-backlog"]}],
}


@pytest.fixture
def serving_cell(monkeypatch):
    """BENCHMARK.json as the harness reads it, with the serving cell added."""
    from benchmark import harness

    load = harness.load_json

    def with_serving(path):
        spec = load(path)
        if os.path.basename(path) == "BENCHMARK.json":
            for key, entries in SERVING.items():
                spec[key] = spec[key] + entries
        return spec

    monkeypatch.setattr(harness, "load_json", with_serving)
