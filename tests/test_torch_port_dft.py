"""The port's matmul-DFT transforms against the JAX package's on the CPU:
``log_power_stft(transform="dft")`` and Griffin-Lim with ``transform="dft"``
from one shared numpy phase, the DFT matrices themselves, and dft against
fft inside the port. On the CPU the matmuls take float32 inputs, as the JAX
package's CPU path does."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_music_style_transfer_tpu.ops import griffinlim as jgl
from ml_music_style_transfer_tpu.ops import reference as npref
from ml_music_style_transfer_tpu.ops import stft as jstft
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue as tglue

N_FFT, HOP = 2048, 256
LOG_ATOL = 1e-3  # the log-space contract of the JAX package's stft.py:215-217


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    y = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.5, 220.0), (0.25, 661.0), (0.1, 1750.0)))
    return (y + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _magnitude(n=44100):
    y = _signal(n, seed=21)
    return np.abs(npref.stft(y.astype(np.float64), N_FFT, HOP)).astype(np.float32)


def _phase(shape, seed=3):
    return (2 * np.pi * np.random.default_rng(seed).random(shape)).astype(np.float32)


def test_dft_matrices_equal_jax_float32():
    fwd, inv = tstft.dft_matrices(N_FFT, torch.float32, torch.device("cpu"))
    jfwd, jinv = jstft._dft_matrices_host(N_FFT, "float32")
    assert fwd.shape == (N_FFT, 2 * 1025) and inv.shape == (2 * 1025, N_FFT)
    np.testing.assert_array_equal(fwd.numpy(), jfwd)
    np.testing.assert_array_equal(inv.numpy(), jinv)


@pytest.mark.parametrize("n", [44100, 219904])
def test_log_power_stft_dft_matches_jax_and_golden(n):
    y = _signal(n, seed=n)
    got = tstft.log_power_stft(torch.from_numpy(y), N_FFT, HOP, transform="dft").numpy()
    want = np.asarray(jstft.log_power_stft(jnp.asarray(y), N_FFT, HOP, transform="dft"))
    golden = npref.log_power(npref.stft(y.astype(np.float64), N_FFT, HOP))
    assert got.shape == want.shape == (1025, 1 + n // HOP)
    assert np.abs(got - want).max() <= LOG_ATOL
    assert np.abs(got - golden).max() <= LOG_ATOL


def test_log_power_stft_dft_center_false_and_batched():
    """The serving path's host-padded input, and a leading batch axis."""
    y = _signal(30000, seed=5)
    half = N_FFT // 2
    padded = torch.from_numpy(np.pad(y, (half, half), mode="reflect"))
    got = tstft.log_power_stft(padded, N_FFT, HOP, transform="dft", center=False)
    want = tstft.log_power_stft(torch.from_numpy(y), N_FFT, HOP, transform="fft")
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= LOG_ATOL
    batch = torch.from_numpy(np.stack([y, 0.5 * y]))
    got_b = tstft.log_power_stft(batch, N_FFT, HOP, transform="dft")
    assert got_b.shape == (2,) + tuple(want.shape)
    assert float((got_b[0] - want).abs().max()) <= LOG_ATOL


@pytest.mark.parametrize("use_glue", [True, False])
def test_griffinlim_dft_matches_jax_from_shared_phase(use_glue):
    """3 iterations from one numpy phase, atol 1e-3 of the waveform's peak
    (the FFT path's parity tolerance: float32 transform rounding)."""
    mag = _magnitude()
    phase = _phase(mag.shape)
    want = np.asarray(jgl.griffinlim(jnp.asarray(mag), n_iter=3, init_phase=jnp.asarray(phase),
                                     use_pallas_glue=False, transform="dft"))
    got = tgl.griffinlim(mag, n_iter=3, init_phase=phase, use_pallas_glue=use_glue,
                         transform="dft", device="cpu").numpy()
    assert got.shape == want.shape == (HOP * (mag.shape[1] - 1),)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_gl_steps_dft_carry_matches_jax():
    """The complex (angles, rebuilt) carry after 2 DFT iterations."""
    mag = _magnitude(30000)
    phase = _phase(mag.shape, seed=4)
    angles = np.exp(1j * phase).astype(np.complex64)
    carry_j = (jnp.asarray(angles), jnp.zeros_like(jnp.asarray(angles)))
    want_a, want_r = jgl.gl_steps(jnp.asarray(mag), carry_j, 2, HOP, N_FFT, transform="dft")
    a0 = torch.from_numpy(angles)
    got_a, got_r = tgl.gl_steps(torch.from_numpy(mag), (a0, torch.zeros_like(a0)), 2, HOP, N_FFT,
                                transform="dft")
    want_r = np.asarray(want_r)
    np.testing.assert_allclose(got_r.numpy(), want_r, atol=1e-3 * np.abs(want_r).max())
    # unit-modulus phases; compared where the rebuilt spectrum is not ~0
    keep = np.abs(want_r) > 1e-2 * np.abs(want_r).max()
    np.testing.assert_allclose(got_a.numpy()[keep], np.asarray(want_a)[keep], atol=1e-3)


def test_dft_against_fft_inside_the_port():
    mag = _magnitude()
    phase = _phase(mag.shape, seed=6)
    fft = tgl.griffinlim(mag, n_iter=4, init_phase=phase, device="cpu").numpy()
    dft = tgl.griffinlim(mag, n_iter=4, init_phase=phase, transform="dft", device="cpu").numpy()
    np.testing.assert_allclose(dft, fft, atol=1e-3 * np.abs(fft).max())


def test_dft_griffinlim_goes_through_the_glue(monkeypatch):
    """The consistency step between the two matmuls is K3's wrapper
    (``gl_consistency_frames``), once per iteration."""
    calls = []
    real = tglue.gl_consistency_frames

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(tglue, "gl_consistency_frames", spy)
    mag = _magnitude(30000)
    tgl.griffinlim(mag, n_iter=3, transform="dft", device="cpu")
    assert calls == [(mag.shape[1], N_FFT)] * 3


def test_dft_griffinlim_refuses_what_it_does_not_take():
    mag = _magnitude(30000)
    length = HOP * (mag.shape[1] - 1) + 100
    with pytest.raises(ValueError, match="dft"):
        tgl.griffinlim(mag, n_iter=1, length=length, transform="dft", device="cpu")
    with pytest.raises(ValueError, match="transform"):
        tgl.griffinlim(mag, n_iter=1, transform="wavelet", device="cpu")
    batch = np.stack([mag, 0.5 * mag])
    out = tgl.griffinlim(batch, n_iter=1, transform="dft", device="cpu")
    assert out.shape == (2, HOP * (mag.shape[1] - 1))
