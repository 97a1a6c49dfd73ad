"""Each driver runs at a tiny width on the CPU through the test hook, and
comes out not correct with its timed path broken underneath: a step that
leaves its state unchanged, half of the batch left out, an answer altered
where it is made. (One chip: no exchange between chips to leave out.)"""
import pytest
import torch

from benchmark import control, harness

SEED = "2147483711"


def run(cell: str, trace: int = 0, seconds: int = 3) -> dict:
    spec = harness.load_json(harness.os.path.join(harness.ROOT, "BENCHMARK.json"))
    c, _, _ = harness.find_cell(spec, cell)
    mix = harness.traffic_file(c["traffic"])
    test = {"device": "cpu", "config": control.TINY[c["config"]],
            "traffic": {**control.TINY_TRAFFIC[mix["driver"]], "backlog": 2,
                        "trace_seconds": seconds / 2}}
    return harness.run(["--workload", cell, "--seed", SEED, "--seconds", str(seconds), "--trace",
                        str(trace)], test=test)


@pytest.mark.parametrize("cell", ["pnet-serve-backlog", "pnet-train-b64", "ae-train-b256"])
def test_driver_runs_at_a_tiny_width(cell, serving_cell):
    r = run(cell)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert r["checks"] and list(r)[-1] == "checks"


def test_traced_run_reports_per_layer_metrics():
    # the profiler starts at the first step issued in the window's last half
    r = run("pnet-train-b64", trace=1, seconds=8)
    assert "train.mfu" in r["metrics"] and "window_s" in r["device"]


# ---- faults ------------------------------------------------------------------

@pytest.fixture
def synth(serving_cell):
    from ml_music_style_transfer_tpu_torch.infer import synthesize
    return synthesize


def test_serving_answer_altered(monkeypatch, synth):
    orig = synth.AudioSynthesizer._griffinlim_device

    def altered(self, spec, t_total, n_iter, seed=0):
        wav = orig(self, spec, t_total, n_iter, seed)
        return torch.cat([wav[: wav.shape[0] // 2], torch.zeros_like(wav[wav.shape[0] // 2:])])

    monkeypatch.setattr(synth.AudioSynthesizer, "_griffinlim_device", altered)
    assert not run("pnet-serve-backlog")["correct"]


def test_serving_griffin_lim_leaves_its_state_unchanged(monkeypatch, synth):
    orig = synth.AudioSynthesizer._gl_waveform
    monkeypatch.setattr(synth.AudioSynthesizer, "_gl_waveform",
                        lambda self, spec, n_iter, seed=0: orig(self, spec, 0, seed))
    assert not run("pnet-serve-backlog")["correct"]


def test_serving_half_the_tiles_left_out(monkeypatch, synth):
    orig = synth.forward_blend

    def half(forward, roll, onoff, cond, starts, valid, t_total, l_out):
        def fwd(*a):
            pred = forward(*a)
            h = pred.shape[0] // 2
            return torch.cat([pred[:h], torch.zeros_like(pred[h:])])
        return orig(fwd, roll, onoff, cond, starts, valid, t_total, l_out)

    monkeypatch.setattr(synth, "forward_blend", half)
    assert not run("pnet-serve-backlog")["correct"]


@pytest.mark.parametrize("cell", ["pnet-train-b64", "ae-train-b256"])
def test_training_step_leaves_the_weights_unchanged(monkeypatch, cell):
    orig = torch.optim.Adam.step

    def still(self, closure=None):
        before = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = orig(self, closure)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups for p in g["params"]), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", still)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", ["pnet-train-b64", "ae-train-b256"])
def test_training_half_the_batch_left_out(monkeypatch, cell):
    from ml_music_style_transfer_tpu_torch.train import losses

    name = "l1_loss" if cell == "pnet-train-b64" else "mel_multiscale_spectral_loss"
    orig = getattr(losses, name)

    def half(pred, target, weight, *a, **k):
        h = pred.shape[0] // 2
        return orig(pred[:h], target[:h], weight[:h], *a, **k)

    monkeypatch.setattr(losses, name, half)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", ["pnet-train-b64", "ae-train-b256"])
def test_training_loss_altered(monkeypatch, cell):
    from ml_music_style_transfer_tpu_torch.train import losses

    name = "l1_loss" if cell == "pnet-train-b64" else "mel_multiscale_spectral_loss"
    orig = getattr(losses, name)
    monkeypatch.setattr(losses, name, lambda *a, **k: 1.5 * orig(*a, **k))
    assert not run(cell)["correct"]


# ---- the control -------------------------------------------------------------

@pytest.mark.parametrize("cell", ["pnet-serve-backlog", "pnet-train-b64", "ae-train-b256"])
def test_control_breaks_a_limit(cell, serving_cell):
    for seed in (11, 12, 13):
        r = control.readings(cell, seed, test=True)
        assert any(v["value"] > v["limit"] for v in r.values()), r
