"""Spectrogram Diffusion (``models/spectrogram_diffusion.py``) against the
plain reference of the benchmark (``benchmark/reference/t5film.py``) on the
CPU at a tiny width (d_model 64, 2 heads, 2 layers a stack, 64 note tokens,
16 frames), on seeded weights (``benchmark/t5_weights.py``), with K2's plain
dropout masks; and the note event codec (``midi/events.py``). The JAX
package has no such family, so the reference is the yardstick.

Tolerances: float32 within 1e-5 relative (the reference sums attention in
its own order; on the CPU it agreed to the bit). bfloat16 within 2e-2
relative: the program rounds the attention scores to bfloat16 before the
float32 softmax and the reference keeps them in float32, which moves the
output by 0.6 % here; the same reference in float8 moves it by 7.9 %.
"""
import numpy as np
import pytest
import torch

from benchmark import harness, sdiff_control, t5_weights
from benchmark.drivers import train_spectrogram_diffusion as train_sdiff
from benchmark.reference import philox, t5film
from ml_music_style_transfer_tpu_torch.midi import Note, events
from ml_music_style_transfer_tpu_torch.models import spectrogram_diffusion as sd
from ml_music_style_transfer_tpu_torch.ops import mel

SEED = 2**63 + 12345  # a step seed over 2**63: both 32-bit halves of the key in use
BATCH = 3
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Tier-1 runs six test workers on one machine: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(dtype: str) -> dict:
    cfg = harness.load_json(harness.os.path.join(harness.ROOT, "benchmark", "configs",
                                                 "spectrogram_diffusion.json"))
    return {**cfg, **sdiff_control.TINY, "compute_dtype": dtype}


def model_and_params(cfg: dict):
    model = sd.SpectrogramDiffusion(train_sdiff.program_config(cfg))
    params = t5_weights.make(cfg, 5, "cpu")
    model.load_state_dict(params, strict=True)
    return model, params


def inputs():
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(3, 1390, (BATCH, 64), generator=g)
    tokens[:, 40:] = events.PAD
    tokens[1, 20:] = events.PAD
    return (tokens, torch.randn(BATCH, 16, 128, generator=g),
            torch.randn(BATCH, 16, 128, generator=g), torch.rand(BATCH, generator=g))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
def test_forward_matches_reference(dtype, training):
    cfg = tiny(dtype)
    model, params = model_and_params(cfg)
    tokens, ctx, x_t, t = inputs()
    masks = (lambda call, shape: philox.mask(SEED, call, shape, cfg["dropout_rate"], "cpu")) \
        if training else None
    with torch.no_grad():
        out = model(tokens, ctx, x_t, t, dropout_seed=SEED if training else None)
        ref = t5film.forward(params, cfg, tokens, ctx, x_t, t, masks=masks)
    assert out.dtype == torch.float32 and out.shape == (BATCH, 16, 128)
    assert rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_loss_and_gradients_match_reference(dtype):
    """One step: features, the noise drawn again from the seed, x_t, the
    forward with dropout, the MSE and its gradients (read before Adam's
    update is applied to them: ``p.grad`` after the step)."""
    cfg = tiny(dtype)
    model, params = model_and_params(cfg)
    trainer = sd.make_spectrogram_diffusion_train_step(model)
    tokens = inputs()[0]
    audio = 0.1 * torch.randn(BATCH, 2, 15 * cfg["hop"], generator=torch.Generator().manual_seed(1))
    loss = float(trainer.step(tokens, audio, SEED))
    ref_params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    batch = t5film.batch(tokens, audio, SEED, cfg)
    ref_loss = t5film.loss_rows(cfg, [SEED])(ref_params, batch, 0, BATCH, 1) / BATCH
    ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    assert abs(loss - ref_loss) <= TOL[dtype] * 1e-2 * abs(ref_loss)
    worst = max(rel(p.grad, ref_params[k].grad) for k, p in model.named_parameters()
                if ref_params[k].grad.norm() > 0)
    assert worst <= TOL[dtype]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
def test_padding_reaches_the_output_only_through_the_mask(training):
    model, _ = model_and_params(tiny("bfloat16"))
    tokens, ctx, x_t, t = inputs()
    mask = tokens > 0
    other = torch.where(mask, tokens, torch.randint_like(tokens, 3, 1390))
    seed = SEED if training else None
    with torch.no_grad():
        a = model(tokens, ctx, x_t, t, notes_mask=mask, dropout_seed=seed)
        b = model(other, ctx, x_t, t, notes_mask=mask, dropout_seed=seed)
    assert torch.equal(a, b)


def test_every_weight_lives_on_the_device_asked_in_one_product_group():
    """Self-attention's q, k, v are one product, cross-attention's k, v,
    the FF's wi_0, wi_1; each linear in one group, on the model's device."""
    model = sd.SpectrogramDiffusion(train_sdiff.program_config(tiny("bfloat16")), device="meta")
    assert {p.device.type for p in model.parameters()} == {"meta"}
    groups = {tuple(n for m in g for n, mod in model.named_modules() if mod is m)
              for g in model.groups}
    assert ("notes.layers.0.attn.q", "notes.layers.0.attn.k", "notes.layers.0.attn.v") in groups
    assert ("decoder.layers.1.cross_attn.k", "decoder.layers.1.cross_attn.v") in groups
    assert ("decoder.layers.1.cross_attn.q",) in groups
    assert ("context.layers.1.ff.wi_0", "context.layers.1.ff.wi_1") in groups
    linears = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    assert sorted(id(m) for g in model.groups for m in g) == sorted(map(id, linears))


# ---- the event codec -----------------------------------------------------------

NOTES = [Note(60, 100, 0.5, 1.5),   # sounding at the start: the tie section, off at step 50
         Note(64, 80, 1.0, 2.0),    # on at step 0, off at 100
         Note(67, 90, 1.5, 3.5),    # on at 50, off after the segment
         Note(72, 70, 2.5, 2.6),    # on at 150, off at 160
         Note(40, 64, 3.2, 3.4)]    # after the segment
# program 0 (1135), pitch p (1004 + p), tie (1134), velocity 0/1 (1132/1133), shift s (3 + s)
EXPECTED = [1135, 1064, 1134,
            1133, 1068,
            53, 1132, 1064, 1133, 1071,
            103, 1132, 1068,
            153, 1133, 1076,
            163, 1132, 1076,
            events.EOS]


@pytest.mark.parametrize("length", [32, 8], ids=["padded", "cut"])
def test_event_codec_on_a_fixed_note_list(length):
    got = events.encode_segment(NOTES, 1.0, 3.0, length)
    want = (EXPECTED + [events.PAD] * length)[:length]
    assert got.dtype == np.int64 and got.tolist() == want
    assert events.N_EVENTS == 1388 and events.token("drum", 127) == 1390


def test_log_mel_frames_of_a_segment():
    """81,600 samples at hop 320 give the 256 frames of a 5.12 s segment."""
    audio = torch.randn(2, 81600, generator=torch.Generator().manual_seed(2))
    m = mel.log_mel_frames(audio)
    assert m.shape == (2, 256, 128) and m.min() >= np.log(1e-5)
