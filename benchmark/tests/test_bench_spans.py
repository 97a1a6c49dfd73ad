"""The readers of the program's spans on a hand-made traced run: device
intervals with known gaps, spans inside and outside the first half, and
nothing to read without spans or without a device trace."""
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.metrics import _spans
from ml_music_style_transfer_tpu_torch.utils import profiling

S = 1_000_000_000  # ns a second
PHASES = ("train.input", "train.forward", "train.loss", "train.backward", "train.optimizer")
# busy 10.00-10.10, 10.15-10.30, 10.32-10.50, 10.60-10.70: gaps at 10.10, 10.30, 10.50
INTERVALS = [("k", 10.0, 10.1), ("k", 10.15, 10.3), ("k", 10.32, 10.5), ("k", 10.6, 10.7)]
WINDOW_S = 0.8


def span(name, sid, step, t0, t1, parent=None, device_s=None, counters=None):
    return profiling.Span(name, sid, parent, step, int(t0 * S), int(t1 * S), device_s,
                          counters or {})


def step(step_id, t0, t1, ms, calls, sid):
    """A train.step over [t0, t1] with its input before it and four phases
    inside it; every phase took ``ms`` on the card."""
    recs = [span("train.step", sid, step_id, t0, t1, counters={"allocator_calls": calls}),
            span("train.input", sid + 1, step_id, t0 - 0.01, t0 - 0.005, device_s=ms / 1e3)]
    for k, name in enumerate(PHASES[1:]):
        a = t0 + (t1 - t0) * k / 4
        recs.append(span(name, sid + 2 + k, step_id, a, a + (t1 - t0) / 4, parent=sid,
                         device_s=ms / 1e3))
    return recs


SPANS = (step(1, 9.5, 9.9, 100.0, 50, 10)       # closed before the first half
         + step(2, 9.95, 10.2, 4.0, 2, 20)      # closed inside it
         + step(3, 10.2, 10.45, 6.0, 4, 30)     # inside
         + step(4, 10.65, 10.9, 100.0, 50, 40)  # closed after it
         + [span("setup.library", 1, None, 1.0, 2.0), span("setup.library", 2, None, 5.0, 5.5),
            span("setup.model", 3, None, 2.0, 3.0), span("setup.model", 4, None, 2.5, 2.8)])


def run_of(intervals=INTERVALS):
    trace = SimpleNamespace(intervals=intervals, window_s=WINDOW_S,
                            busy_s=sum(e - s for _, s, e in intervals))
    return SimpleNamespace(trace=trace, records={"steps": 10}, config={}, traffic={})


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))


@pytest.mark.parametrize("name,want", [
    ("train.input_ms", 5.0), ("train.forward_ms", 5.0), ("train.loss_ms", 5.0),
    ("train.backward_ms", 5.0), ("train.optimizer_ms", 5.0),
    # gaps at 10.10 (step 2 open) and 10.30 (step 3 open) count; 10.50 (none open) does not
    ("train.program_idle_share", 100.0 * (0.05 + 0.02) / WINDOW_S),
    ("train.allocator_calls_per_step", 3.0),
    ("setup.library_s", 1.5), ("setup.model_s", 1.0)])
def test_reader_on_a_hand_made_run(recorded, name, want):
    assert harness.metric_reader(name)(run_of()) == pytest.approx(want, rel=1e-6)


def test_program_idle_is_at_most_device_idle(recorded):
    run = run_of()
    prog = harness.metric_reader("train.program_idle_share")(run)
    dev = harness.metric_reader("train.device_idle_share")(run)
    assert 0 < prog < dev


def test_gap_owner_is_the_innermost_open_span():
    recs = [span("train.step", 1, 1, 0.0, 1.0), span("train.backward", 2, 1, 0.2, 0.6, parent=1),
            span("other", 3, None, 0.5, 2.0)]
    owners = [(g0, o.name if o else None)
              for g0, _, o in _spans.gap_owners([(0.1, 0.15), (0.3, 0.4), (0.55, 0.6),
                                                 (0.7, 0.8), (2.5, 3.0)], recs)]
    assert owners == [(0.1, "train.step"), (0.3, "train.backward"), (0.55, "other"),
                      (0.7, "other"), (2.5, None)]


@pytest.mark.parametrize("case", ["no trace", "no intervals", "no spans", "no span api"])
def test_nothing_to_read_gives_none(monkeypatch, case):
    run = run_of()
    if case == "no trace":
        run.trace = None
        monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    elif case == "no intervals":
        run = run_of([])
        monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    elif case == "no spans":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    else:  # a program that records no spans at all
        monkeypatch.delattr(profiling, "spans")
    for name in ("train.input_ms", "train.forward_ms", "train.loss_ms", "train.backward_ms",
                 "train.optimizer_ms", "train.program_idle_share",
                 "train.allocator_calls_per_step", "setup.library_s", "setup.model_s"):
        assert harness.metric_reader(name)(run) is None, name
