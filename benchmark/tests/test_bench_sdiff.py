"""The Spectrogram Diffusion cell at a tiny width on the CPU through the test
hook: correct as it stands, not correct with its timed path broken
underneath (a step that leaves the weights unchanged, half of the batch
left out, the loss times 1.5), the float8 control breaking a limit; its
readers on hand-made spans and counters, the generic span readers it is
listed for on the spans the program records in its step, and the
reference's pieces (row-block masks, the FLOP count)."""
import math
import statistics
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, sdiff_control, sdiff_roofline, t5_weights, roofline
from benchmark.drivers import train_spectrogram_diffusion as train_sdiff
from benchmark.reference import philox, t5film
from ml_music_style_transfer_tpu_torch.utils import profiling

CELL = "sdiff-train-b8"
SEED = "2147483711"
S = 1_000_000_000  # ns a second


def run(trace: int = 0, seconds: int = 3) -> dict:
    test = {"device": "cpu", "config": sdiff_control.TINY,
            "traffic": {**sdiff_control.TINY_TRAFFIC, "trace_seconds": seconds / 2}}
    return harness.run(["--workload", CELL, "--seed", SEED, "--seconds", str(seconds), "--trace",
                        str(trace)], test=test)


def test_cell_runs_correct_at_a_tiny_width():
    r = run()
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_traced_run_reports_the_step_share():
    r = run(trace=1, seconds=8)
    assert "sdiff.mfu" in r["metrics"] and "window_s" in r["device"]


# ---- faults planted in the program ----------------------------------------------

def test_training_step_leaves_the_weights_unchanged(monkeypatch):
    orig = torch.optim.Adam.step

    def still(self, closure=None):
        before = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = orig(self, closure)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups for p in g["params"]), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", still)
    assert not run()["correct"]


@pytest.mark.parametrize("fault", ["half_batch", "scaled_loss"])
def test_training_loss_altered(monkeypatch, fault):
    orig = F.mse_loss  # the program's loss; the reference writes its own

    def half(pred, target, *a, **k):
        h = pred.shape[0] // 2
        return orig(pred[:h], target[:h], *a, **k)

    monkeypatch.setattr(F, "mse_loss", half if fault == "half_batch"
                        else (lambda *a, **k: 1.5 * orig(*a, **k)))
    assert not run()["correct"]


def test_control_breaks_a_limit():
    for seed in (11, 12, 13):
        r = sdiff_control.readings(CELL, seed, test=True)
        assert any(v["value"] > v["limit"] for v in r.values()), r


# ---- the readers on hand-made spans -----------------------------------------------

INTERVALS = [("k", 10.0, 10.5)]  # the first half: steps closing in 10.0-10.5 count


def span(name, sid, step, t0, t1, parent=None, device_s=None, counters=None):
    return profiling.Span(name, sid, parent, step, int(t0 * S), int(t1 * S), device_s,
                          counters or {})


def hand_made_step(step_id, t1, ms, tokens, sid):
    """A train.step closing at ``t1``: its forward spans, two attention cores
    of ``ms`` each inside the notes encoder, and its counters."""
    t0 = t1 - 0.1
    return [span("train.step", sid, step_id, t0, t1,
                 counters={"notes_tokens": tokens, "notes_positions": 1000}),
            span("sdiff.notes_encoder", sid + 1, step_id, t0, t0 + 0.03, sid, 3 * ms / 1e3),
            span("sdiff.attention", sid + 2, step_id, t0, t0 + 0.01, sid + 1, ms / 1e3),
            span("sdiff.attention", sid + 3, step_id, t0 + 0.01, t0 + 0.02, sid + 1, ms / 1e3),
            span("sdiff.decoder", sid + 4, step_id, t0 + 0.03, t0 + 0.05, sid, 2 * ms / 1e3)]


HAND = (hand_made_step(1, 10.2, 1.0, 200, 10) + hand_made_step(2, 10.3, 2.0, 300, 20)
        + hand_made_step(3, 10.4, 4.0, 400, 30) + hand_made_step(4, 11.0, 50.0, 1000, 40))


def run_of(intervals=INTERVALS, records=None):
    trace = SimpleNamespace(intervals=intervals, window_s=0.5,
                            busy_s=sum(e - s for _, s, e in intervals), t0=10.0)
    return SimpleNamespace(trace=trace, records=records or {}, config={}, traffic={})


@pytest.mark.parametrize("name,want", [
    ("sdiff.attention_ms", 4.0),      # two cores a step: 2, 4 and 8 ms, median 4
    ("sdiff.notes_encoder_ms", 6.0),  # 3, 6, 12
    ("sdiff.decoder_ms", 4.0),        # 2, 4, 8
    ("sdiff.notes_pad_share", 100.0 * (1 - 900 / 3000))])  # steps 1-3; step 4 is not read
def test_reader_on_hand_made_spans(monkeypatch, name, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(HAND))
    assert harness.metric_reader(name)(run_of()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["sdiff.attention_ms", "sdiff.notes_encoder_ms",
                                  "sdiff.decoder_ms", "sdiff.notes_pad_share"])
@pytest.mark.parametrize("case", ["no_trace", "no_spans", "no_counters"])
def test_nothing_to_read_is_none(monkeypatch, name, case):
    spans = [] if case == "no_spans" else [
        span("train.step", 1, 1, 10.1, 10.2, counters={"allocator_calls": 0}),
        span("other", 2, 1, 10.1, 10.2, 1, 0.001)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert harness.metric_reader(name)(run_of([] if case == "no_trace" else INTERVALS)) is None


def test_step_share_of_the_peak():
    cfg = harness.load_json(harness.os.path.join(harness.ROOT, "benchmark", "configs",
                                                 "spectrogram_diffusion.json"))
    records = {"steps": 40, "t0": 5.0, "seconds": 10.0, "batch": 8,
               "issued": [5.0 + 0.25 * i for i in range(40)]}
    r = SimpleNamespace(trace=SimpleNamespace(t0=10.0), records=records, config=cfg, traffic={})
    want = 100.0 * 3 * sdiff_roofline.forward_flops(cfg, 8) * 20 / (5.0 * roofline.BF16_FLOPS_PER_S)
    assert harness.metric_reader("sdiff.mfu")(r) == pytest.approx(want, rel=1e-12)
    r.trace = None  # untraced: the whole window, twice the steps in twice the time
    assert harness.metric_reader("sdiff.mfu")(r) == pytest.approx(want, rel=1e-12)


# ---- the generic readers on the program's own spans -------------------------------

GENERIC = ("train.input_ms", "train.forward_ms", "train.loss_ms", "train.backward_ms",
           "train.optimizer_ms", "train.program_idle_share", "train.device_idle_share",
           "train.allocator_calls_per_step", "setup.model_s")


@pytest.fixture(scope="module")
def program_run():
    """Three steps of the tiny program recorded on the CPU under a profiler,
    the numbers only the card gives filled in by hand: each span's device
    time (its host time here) and the step's allocator counter (0). The
    trace is busy over the whole run but for a gap in the middle step."""
    cfg = {**harness.load_json(harness.os.path.join(harness.ROOT, "benchmark", "configs",
                                                    "spectrogram_diffusion.json")),
           **sdiff_control.TINY}
    mix = {**harness.traffic_file("sdiff_notes_b8"), **sdiff_control.TINY_TRAFFIC}
    from ml_music_style_transfer_tpu_torch.models.spectrogram_diffusion import (
        SpectrogramDiffusion, make_spectrogram_diffusion_train_step)

    profiling.clear_spans()
    model = SpectrogramDiffusion(train_sdiff.program_config(cfg))
    trainer = make_spectrogram_diffusion_train_step(model)
    tokens, audio = train_sdiff.make_tokens(cfg, mix, 7), train_sdiff.make_audio(cfg, mix, 7, "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(3):
            trainer.step(tokens[4 * i % 8:4 * i % 8 + 4], audio[:4], 1000 + i)
    spans = profiling.spans()
    profiling.clear_spans()
    for r in spans:
        if r.step is not None:
            r.device_s = (r.end_ns - r.start_ns) / S
        if r.name == "train.step":
            r.counters["allocator_calls"] = 0
    steps = sorted((r for r in spans if r.name == "train.step"), key=lambda r: r.start_ns)
    lo, hi = steps[0].start_ns / S - 1e-3, steps[-1].end_ns / S + 1e-3  # every step inside
    mid = (steps[1].start_ns + steps[1].end_ns) / 2 / S
    intervals = [("k", lo, mid - 1e-3), ("k", mid, hi)]
    trace = SimpleNamespace(intervals=intervals, window_s=hi - lo,
                            busy_s=hi - lo - 1e-3, t0=lo)
    want_tokens = sum(int(torch.count_nonzero(tokens[4 * i % 8:4 * i % 8 + 4])) for i in range(3))
    return spans, trace, 100.0 * (1 - want_tokens / (3 * 4 * cfg["max_length"]))


@pytest.mark.parametrize("name", GENERIC + ("sdiff.attention_ms", "sdiff.notes_encoder_ms",
                                            "sdiff.decoder_ms"))
def test_reader_gives_a_sound_number_on_the_programs_spans(monkeypatch, program_run, name):
    spans, trace, _ = program_run
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    run = SimpleNamespace(trace=trace, records={"steps": 3}, config={}, traffic={})
    v = harness.metric_reader(name)(run)
    assert v is not None and math.isfinite(v) and v >= 0, (name, v)
    step_ms = statistics.median(1e3 * r.device_s for r in spans if r.name == "train.step")
    if name.endswith("_ms"):
        assert 0 < v < step_ms
    if name == "train.allocator_calls_per_step":
        assert v == 0
    if name == "train.program_idle_share":
        assert 0 < v <= harness.metric_reader("train.device_idle_share")(run)
    if name in ("sdiff.attention_ms", "sdiff.notes_encoder_ms", "sdiff.decoder_ms"):
        assert v < harness.metric_reader("train.forward_ms")(run)


def test_pad_share_matches_the_traffic(monkeypatch, program_run):
    spans, trace, want = program_run
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    run = SimpleNamespace(trace=trace, records={"steps": 3}, config={}, traffic={})
    assert harness.metric_reader("sdiff.notes_pad_share")(run) == pytest.approx(want, rel=1e-12)


# ---- the reference's pieces -------------------------------------------------------

@pytest.mark.parametrize("r0,r1", [(0, 2), (1, 3), (2, 3)])
def test_row_block_masks_are_philox_masks(r0, r1):
    shape = (3, 2, 5, 7)  # 70 elements a row: blocks start inside a Philox word
    full = philox.mask(2**63 + 99, 17, shape, 0.1, "cpu")
    assert torch.equal(t5film.mask_rows(2**63 + 99, 17, shape, 0.1, r0, r1, "cpu"),
                       full[r0:r1])


def test_flop_count_matches_the_reference_forward():
    from torch.utils.flop_counter import FlopCounterMode

    cfg = {**harness.load_json(harness.os.path.join(harness.ROOT, "benchmark", "configs",
                                                    "spectrogram_diffusion.json")),
           **sdiff_control.TINY}
    p = {k: torch.empty(s, device="meta") for k, s in t5film.shapes(cfg).items()}
    b = 3
    tokens = torch.ones((b, cfg["max_length"]), dtype=torch.long, device="meta")
    ctx = torch.empty((b, cfg["targets_context_length"], cfg["input_dims"]), device="meta")
    x_t = torch.empty((b, cfg["targets_length"], cfg["input_dims"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        t5film.forward(p, cfg, tokens, ctx, x_t, torch.empty(b, device="meta"))
    assert sdiff_roofline.forward_flops(cfg, b) == counter.get_total_flops()


def test_seeded_weights_follow_t5s_initialisation():
    cfg = harness.load_json(harness.os.path.join(harness.ROOT, "benchmark", "configs",
                                                 "spectrogram_diffusion.json"))
    cfg = {**cfg, **sdiff_control.TINY, "d_model": 256, "d_ff": 512}
    w = t5_weights.make(cfg, 3, "cpu")
    assert torch.equal(w["notes.final_norm.weight"], torch.ones(256))
    for name, std in [("notes.layers.0.attn.q.weight", (256 * 32) ** -0.5),
                      ("decoder.layers.1.ff.wo.weight", 512 ** -0.5),
                      ("notes.token_embedder.weight", 1.0),
                      ("decoder.cond_2.weight", (2.0 / (2 * 1024)) ** 0.5)]:
        assert float(w[name].std()) == pytest.approx(std, rel=0.05), name
