"""The reader of the convolutions' channel-last share on hand-made traced
runs: steps whose ``train.step`` spans carry the conv counters, and runs
with none to read."""
from types import SimpleNamespace

import pytest

from benchmark import harness
from ml_music_style_transfer_tpu_torch.utils import profiling

S = 1_000_000_000
INTERVALS = [("k", 10.0, 10.5)]  # the first half: steps closing in 10.0-10.5 count


def step(sid, t1, counters):
    return profiling.Span("train.step", sid, None, sid, int((t1 - 0.1) * S), int(t1 * S), 0.1,
                          counters)


def run_of(spans, monkeypatch, intervals=INTERVALS):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    trace = SimpleNamespace(intervals=intervals, window_s=0.5, busy_s=0.5)
    return SimpleNamespace(trace=trace, records={}, config={}, traffic={})


READ = harness.metric_reader("train.conv_channel_last_share")


@pytest.mark.parametrize("counters,want", [
    # every call channel-last; a step after the first half is not read
    ([{"conv_calls": 99, "conv_channel_last_calls": 99}] * 2, 100.0),
    # 99 + 99 calls, 98 + 99 channel-last
    ([{"conv_calls": 99, "conv_channel_last_calls": 98},
      {"conv_calls": 99, "conv_channel_last_calls": 99}], 100.0 * 197 / 198),
    # a counter that did not move is left off the step: none channel-last
    ([{"conv_calls": 9}, {"conv_calls": 9, "allocator_calls": 0}], 0.0),
])
def test_share_of_the_first_halfs_calls(monkeypatch, counters, want):
    spans = [step(i + 1, 10.2 + 0.1 * i, c) for i, c in enumerate(counters)]
    spans.append(step(9, 11.0, {"conv_calls": 50, "conv_channel_last_calls": 0}))
    assert READ(run_of(spans, monkeypatch)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["no_counters", "no_spans", "no_trace"])
def test_nothing_to_read_is_none(monkeypatch, case):
    spans = [] if case == "no_spans" else [step(1, 10.2, {"allocator_calls": 0}),
                                           step(2, 10.3, {})]
    run = run_of(spans, monkeypatch, [] if case == "no_trace" else INTERVALS)
    assert READ(run) is None
