"""The port's spans and counters (``utils/profiling.py``) on the CPU: off
unless a profiler runs, stamped on the profiler's clock, recorded at the
train step's layer boundaries in both model families and at set-up, and
kept in a bounded store. Width 1/16, float32."""
import time

import numpy as np
import pytest
import torch

from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.data.device_store import DeviceDataStore
from ml_music_style_transfer_tpu_torch.models.autoencoder import (AutoencoderConfig,
                                                                  SpectrogramAutoencoder,
                                                                  make_autoencoder_train_step)
from ml_music_style_transfer_tpu_torch.ops.kernels import _build, _library
from ml_music_style_transfer_tpu_torch.train.loop import Trainer
from ml_music_style_transfer_tpu_torch.utils import profiling

TINY = ModelConfig(width_mult=1 / 16, compute_dtype="float32")
PHASES = ("train.forward", "train.loss", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def cpu_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def resident_store(n=4, seed=0):
    rng = np.random.default_rng(seed)
    roll = (rng.random((n, 860, 128)) < 0.02).astype(np.int8)
    raw = {"pianoroll": roll, "onoff": roll.copy(),
           "audio_cuba": rng.standard_normal((n, 219904)).astype(np.float32) * 0.05}
    return DeviceDataStore.from_arrays(raw, seed=seed, audio_dtype=torch.float32, device="cpu")


def test_no_profiler_records_nothing_and_opens_nothing(monkeypatch):
    """With no profiler a span is one shared no-op: no record_function, no
    CUDA event, no counter read, no record."""
    def refuse(*a, **k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling, "_allocator_calls", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("train.step", step=True)
    assert first is profiling.span("train.forward") is profiling.span("data.plan", device=False)
    with first:
        with profiling.span("train.forward"):
            torch.ones(8).sum()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_span_ends_agree_with_the_profilers_record_of_the_range():
    """Host ends by time.time_ns() bracket the profiler's own record of the
    range the span opens, within 1 ms: one clock, no conversion."""
    with cpu_profiler() as prof:
        with profiling.span("mmst.clock_check"):
            time.sleep(0.005)
    (rec,) = profiling.spans()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "mmst.clock_check"]
    assert abs(ev.start_ns() - rec.start_ns) < 1_000_000
    assert abs(ev.end_ns() - rec.end_ns) < 1_000_000
    assert rec.end_ns - rec.start_ns >= 5_000_000 and rec.device_s is None


def test_trainer_step_records_its_phases_under_one_step():
    """One resident step (plan, gather, train_step): ``train.step`` holds the
    four phases as children, and the plan and the gather, drawn before it,
    carry its step id."""
    store = resident_store()
    tr = Trainer(TINY, TrainConfig(batch_size=2, seed=0), device="cpu", use_native_loader=False)
    tr.init_state(0)
    feed = store.draw_epoch_indices(2)
    profiling.clear_spans()
    with cpu_profiler():
        for _ in range(2):
            batch = store.local_batch(*next(feed))
            assert np.isfinite(float(tr.train_step(batch, tr.next_dropout_seed())))
    recs = profiling.spans()
    named = by_name(recs)
    steps = named["train.step"]
    assert [s.step for s in steps] == [steps[0].step, steps[0].step + 1]
    for s in steps:
        kids = [r for r in recs if r.parent == s.id]
        assert sorted(r.name for r in kids) == sorted(PHASES)
        assert all(r.step == s.step and s.start_ns <= r.start_ns <= r.end_ns <= s.end_ns
                   for r in kids)
    for name in ("train.input", "data.plan"):
        assert [r.step for r in named[name]] == [s.step for s in steps]
        assert all(r.parent is None for r in named[name])
    assert all(r.device_s is None for r in recs)


def test_autoencoder_step_records_the_same_phases():
    model = SpectrogramAutoencoder(AutoencoderConfig(n_bins=16, width=8), device="cpu")
    trainer = make_autoencoder_train_step(model, sr=8000, n_fft=64)
    spec = torch.log1p(torch.rand(2, 16, 33))
    profiling.clear_spans()
    with cpu_profiler():
        assert np.isfinite(float(trainer.step(spec, torch.ones(2))))
    recs = profiling.spans()
    (step,) = by_name(recs)["train.step"]
    kids = [r for r in recs if r.parent == step.id]
    assert sorted(r.name for r in kids) == sorted(("train.input",) + PHASES)
    assert {r.step for r in kids} == {step.step}


@pytest.mark.parametrize("build", ["trainer", "autoencoder", "library"])
def test_setup_spans_are_recorded_without_a_profiler(build, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    if build == "trainer":
        Trainer(TINY, TrainConfig(batch_size=2), device="cpu").init_state(0)
        want = ["setup.model", "setup.model"]
    elif build == "autoencoder":
        make_autoencoder_train_step(SpectrogramAutoencoder(AutoencoderConfig(16, 8), "cpu"))
        want = ["setup.model", "setup.model"]
    else:
        _library._load()
        _library._load.cache_clear()
        monkeypatch.setattr(_build, "build_all", lambda: time.sleep(0.002))
        monkeypatch.setattr(torch.ops, "load_library", lambda path: None)
        monkeypatch.setattr(torch.library, "register_autograd", lambda *a, **k: None)
        _library._load()
        want = ["setup.library"]
    recs = profiling.spans()
    assert [r.name for r in recs] == want
    assert all(r.step is None and r.parent is None and r.end_ns > r.start_ns for r in recs)
    if build == "library":
        assert recs[0].end_ns - recs[0].start_ns >= 2_000_000


def test_store_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with cpu_profiler():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [r.name for r in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.dropped_spans() == 2
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_step_ids_and_parents():
    """A span outside every step belongs to the step that opens next; one
    inside a step to that step; set-up spans to none."""
    with cpu_profiler():
        with profiling.span("before"):
            with profiling.span("inner"):
                pass
        with profiling.span("train.step", step=True):
            with profiling.span("phase"):
                pass
        with profiling.setup_span("setup.x"):
            pass
    n = {r.name: r for r in profiling.spans()}
    assert n["before"].step == n["inner"].step == n["train.step"].step == n["phase"].step
    assert n["inner"].parent == n["before"].id and n["phase"].parent == n["train.step"].id
    assert n["setup.x"].step is None and n["train.step"].parent is None


def test_step_counts_the_allocators_calls_while_open(monkeypatch):
    """The allocator's count is read at a step's ends; before CUDA starts it
    reads nothing and the step has no counter. Other spans read nothing."""
    with cpu_profiler():
        with profiling.span("train.step", step=True):
            pass
    assert profiling.spans()[0].counters == {}
    profiling.clear_spans()
    ticks = iter([10, 17])
    monkeypatch.setattr(profiling, "_allocator_calls", lambda: next(ticks))
    with cpu_profiler():
        with profiling.span("train.step", step=True):
            with profiling.span("train.forward"):
                pass
    fwd, step = profiling.spans()
    assert step.counters == {"allocator_calls": 7} and fwd.counters == {}


class FakeEvent:
    """A CUDA event stand-in: ``record`` stamps the host clock."""

    made = 0

    def __init__(self):
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_device_seconds_resolve_when_read_and_events_are_pooled(monkeypatch):
    """On the card a span records two events; ``spans()`` turns them into
    seconds and gives the events back, so later spans reuse them."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: FakeEvent())
    monkeypatch.setattr(profiling, "_allocator_calls", lambda: None)
    FakeEvent.made = 0
    with cpu_profiler():
        with profiling.span("a"):
            time.sleep(0.003)
        with profiling.span("plan", device=False):
            pass
    first = profiling.spans()
    assert first[0].device_s >= 0.003 and first[0].events is None
    assert first[1].device_s is None and FakeEvent.made == 2
    with cpu_profiler():
        with profiling.span("b"):
            pass
    assert FakeEvent.made == 2 and profiling.spans()[-1].device_s is not None
