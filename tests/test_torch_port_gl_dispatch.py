"""Griffin-Lim's dispatch by shape and the STFT's pad modes against the JAX
package on the CPU.

With default arguments the port's ``griffinlim`` runs the glue kernels
where they take the clip and the istft -> stft loop on every other input,
as the JAX package does (``ops/griffinlim.py:94-110``). The inputs the
glue does not take (a ``length``, a shorter window, another hop, fewer than
24 frames, a batch of such clips) go through both packages from one numpy
phase, 4 iterations (2 at 8 frames, see ``test_eight_frames_in_float64``),
and agree within 1e-5 of the waveform's peak (float32 FFT rounding); an
explicit ``use_pallas_glue=True`` on them raises, naming
the rule. ``stft``'s ``pad_mode`` agrees with JAX's within 1e-5 of the
peak.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_music_style_transfer_tpu.ops import griffinlim as jgl
from ml_music_style_transfer_tpu.ops import pallas as jpallas
from ml_music_style_transfer_tpu.ops import reference as npref
from ml_music_style_transfer_tpu.ops import stft as jstft
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import stft as tstft

N_FFT, HOP, BINS = 2048, 256, 1025
N_ITER = 4
TOL = 1e-5  # of the waveform's peak


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _magnitude(shape, seed=0):
    """|STFT| of a seeded harmonic signal, (..., bins, frames): each clip
    of a batch at its own scale."""
    n_frames = shape[-1]
    t = np.arange(HOP * (n_frames - 1)) / 44100.0
    y = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.5, 220.0), (0.25, 661.0),
                                                       (0.1, 1750.0)))
    y = y + 0.01 * np.random.default_rng(seed).standard_normal(t.shape)
    mag = np.abs(npref.stft(y, N_FFT, HOP)).astype(np.float32)
    scale = np.arange(1, int(np.prod(shape[:-2], dtype=int)) + 1, dtype=np.float32)
    return (scale[:, None, None] * mag).reshape(shape)


def _phase(shape, seed=1):
    return (2 * np.pi * np.random.default_rng(seed).random(shape)).astype(np.float32)


# (name, magnitude shape, iterations, griffinlim keyword arguments): the
# inputs the glue kernels do not take
UNSUPPORTED = [
    ("length", (BINS, 40), N_ITER, dict(length=10084)),
    ("win_length_1024", (BINS, 40), N_ITER, dict(win_length=1024)),
    ("hop_128", (BINS, 40), N_ITER, dict(hop_length=128)),
    ("hop_512", (BINS, 40), N_ITER, dict(hop_length=512)),
    ("hop_1024", (BINS, 40), N_ITER, dict(hop_length=1024)),
    ("frames_8", (BINS, 8), 2, {}),
    ("frames_20", (BINS, 20), N_ITER, {}),
    ("batch_2x2x20", (2, 2, BINS, 20), N_ITER, {}),
]


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name,shape,n_iter,kw", UNSUPPORTED, ids=[c[0] for c in UNSUPPORTED])
def test_default_answers_what_jax_answers(name, shape, n_iter, kw):
    mag, phase = _magnitude(shape), _phase(shape)
    want = np.asarray(jgl.griffinlim(jnp.asarray(mag), n_iter=n_iter,
                                     init_phase=jnp.asarray(phase), **kw))
    got = tgl.griffinlim(mag, n_iter=n_iter, init_phase=phase, device="cpu", **kw).numpy()
    _close(got, want)
    explicit = tgl.griffinlim(mag, n_iter=n_iter, init_phase=phase, use_pallas_glue=False,
                              device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, explicit)


def test_eight_frames_in_float64():
    """An 8-frame clip is ill-conditioned in float32: its NOLA curve reaches
    1.8e11 and the momentum grows the rounding, so at 4 iterations both
    packages' float32 answers lie 3e-5-4e-5 of the peak from a float64 run
    of the same iteration (the port's ``gl_steps`` on float64 tensors), and
    1.5e-5 from each other. The port must be no further from float64 than
    the JAX package is."""
    shape = (BINS, 8)
    mag, phase = _magnitude(shape), _phase(shape)
    m64, p64 = torch.from_numpy(mag.astype(np.float64)), torch.from_numpy(phase.astype(np.float64))
    ang = torch.polar(torch.ones_like(p64), p64)
    ang, _ = tgl.gl_steps(m64, (ang, torch.zeros_like(ang)), N_ITER, HOP, N_FFT)
    exact = tstft.istft(m64 * ang, HOP, N_FFT).numpy()
    want = np.asarray(jgl.griffinlim(jnp.asarray(mag), n_iter=N_ITER,
                                     init_phase=jnp.asarray(phase)))
    got = tgl.griffinlim(mag, n_iter=N_ITER, init_phase=phase, device="cpu").numpy()
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


@pytest.mark.parametrize("name,shape,n_iter,kw", UNSUPPORTED, ids=[c[0] for c in UNSUPPORTED])
def test_explicit_glue_raises_naming_the_rule(name, shape, n_iter, kw):
    mag = _magnitude(shape)
    with pytest.raises(ValueError, match="hop = n_fft/8 .* at least 24 frames"):
        tgl.griffinlim(mag, n_iter=1, init_phase=_phase(shape), use_pallas_glue=True,
                       device="cpu", **kw)


def test_from_log_power_with_length():
    """JAX's ``griffinlim_from_log_power`` is ``griffinlim`` of
    ``inverse_log_power``, drawing its phase from a key; from one phase the
    port's equals that composition, and the lengths agree with JAX's own
    call."""
    spec = 4.0 * _magnitude((BINS, 40), seed=2)
    phase, length = _phase((BINS, 40)), 10084
    want = np.asarray(jgl.griffinlim(jstft.inverse_log_power(jnp.asarray(spec)), n_iter=N_ITER,
                                     init_phase=jnp.asarray(phase), length=length))
    got = tgl.griffinlim_from_log_power(spec, n_iter=N_ITER, length=length, init_phase=phase,
                                        device="cpu").numpy()
    _close(got, want)
    assert np.asarray(jgl.griffinlim_from_log_power(jnp.asarray(spec), n_iter=1,
                                                    length=length)).shape == (length,)
    with pytest.raises(ValueError, match="length=None"):
        tgl.griffinlim_from_log_power(spec, n_iter=1, length=length, use_pallas_glue=True,
                                      device="cpu")


def test_supported_clip_still_takes_the_glue(monkeypatch):
    """A clip the kernels take runs the glue under the default, once per
    iteration, bit-equal to ``use_pallas_glue=True``."""
    mag, phase = _magnitude((BINS, 40)), _phase((BINS, 40))
    glue = tgl.griffinlim(mag, n_iter=N_ITER, init_phase=phase, use_pallas_glue=True,
                          device="cpu")
    calls = []
    real = tgl._glue.gl_consistency_frames
    monkeypatch.setattr(tgl._glue, "gl_consistency_frames",
                        lambda *a: calls.append(1) or real(*a))
    default = tgl.griffinlim(mag, n_iter=N_ITER, init_phase=phase, device="cpu")
    assert torch.equal(default, glue) and len(calls) == N_ITER
    tgl.griffinlim(mag, n_iter=N_ITER, init_phase=phase, use_pallas_glue=False, device="cpu")
    assert len(calls) == N_ITER


def test_resolve_rules_match_jax(monkeypatch):
    """``resolve_transform`` answers as the JAX rule does off a TPU ("fft"
    everywhere); ``resolve_pallas_glue`` answers as the JAX rule does where
    its kernels run (``on_tpu`` true: the card plays the TPU's part), over a
    grid of frame counts, FFT sizes, hops and windows."""
    grid = [(nf, n_fft, hop, win) for nf in (8, 23, 24, 40, 1720)
            for n_fft in (512, 1024, 2048) for hop in (32, 64, 128, 256, 512)
            for win in (n_fft, n_fft // 2)]
    for nf, n_fft, hop, win in grid:
        for ndim, length in ((2, None), (2, 100), (3, None)):
            assert (tgl.resolve_transform(ndim, n_fft, win, length)
                    == jgl.resolve_transform(ndim, n_fft, win, length) == "fft")
    monkeypatch.setattr(jpallas, "on_tpu", lambda: True)
    answers = [tgl.resolve_pallas_glue(*g) for g in grid]
    assert answers == [jgl.resolve_pallas_glue(*g) for g in grid]
    assert any(answers) and not all(answers)


@pytest.mark.parametrize("mode", ["reflect", "constant", "edge"])
def test_stft_pad_mode_matches_jax(mode):
    rng = np.random.default_rng(5)
    y = rng.standard_normal((2, 20000)).astype(np.float32) + 0.5  # a non-zero edge
    want = np.asarray(jstft.stft(jnp.asarray(y), N_FFT, HOP, pad_mode=mode))
    got = tstft.stft(torch.from_numpy(y), N_FFT, HOP, pad_mode=mode).numpy()
    assert got.shape == want.shape == (2, BINS, 1 + 20000 // HOP)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


def test_stft_pad_mode_refuses_others():
    with pytest.raises(ValueError, match="pad_mode"):
        tstft.stft(torch.zeros(4096), N_FFT, HOP, pad_mode="wrap")
