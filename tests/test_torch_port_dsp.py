"""The port's DSP path against the JAX package on the CPU: STFT/iSTFT, the
Griffin-Lim consistency glue's plain version and Griffin-Lim itself.
Inputs come from numpy seeds and go through both packages; tolerances are
stated per test. The glue kernel's own tests are in
tests/test_torch_port_kernels.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_music_style_transfer_tpu.ops import griffinlim as jgl
from ml_music_style_transfer_tpu.ops import reference as npref
from ml_music_style_transfer_tpu.ops import stft as jstft
from ml_music_style_transfer_tpu.ops.pallas import gl_glue as jglue
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue as tglue

N_FFT, HOP = 2048, 256


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    y = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.5, 220.0), (0.25, 661.0), (0.1, 1750.0)))
    return (y + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _glue_consts(nf):
    window = tstft.window_const(N_FFT, N_FFT)
    inv = tstft.wss_inv_const(N_FFT, N_FFT, HOP, nf).reshape(nf + 7, HOP)
    return window, inv


class TestStft:
    # log-space contract of ops/stft.py:215-217: 1e-3 against the float64 golden
    LOG_ATOL = 1e-3

    @pytest.mark.parametrize("n", [44100, 219904])
    def test_log_power_stft_matches_jax_and_golden(self, n):
        y = _signal(n, seed=n)
        got = tstft.log_power_stft(torch.from_numpy(y), N_FFT, HOP).numpy()
        want_jax = np.asarray(jstft.log_power_stft(jnp.asarray(y), N_FFT, HOP, transform="fft"))
        golden = npref.log_power(npref.stft(y.astype(np.float64), N_FFT, HOP))
        assert got.shape == golden.shape == (1025, 1 + n // HOP)
        np.testing.assert_allclose(got, want_jax, atol=self.LOG_ATOL)
        np.testing.assert_allclose(got, golden, atol=self.LOG_ATOL)

    def test_center_false_on_host_padded_signal(self):
        """The serving path reflect-pads on the host and zero-pads to a
        bucket; frames over the true signal equal the centred STFT."""
        y = _signal(30000, seed=3)
        padded = np.pad(y, (N_FFT // 2, N_FFT // 2), mode="reflect")
        bucketed = np.pad(padded, (0, 5 * HOP))
        got = tstft.log_power_stft(torch.from_numpy(bucketed), N_FFT, HOP, center=False).numpy()
        want = np.asarray(jstft.log_power_stft(jnp.asarray(bucketed), N_FFT, HOP,
                                               transform="fft", center=False))
        centred = tstft.log_power_stft(torch.from_numpy(y), N_FFT, HOP).numpy()
        np.testing.assert_allclose(got, want, atol=self.LOG_ATOL)
        nv = centred.shape[1]
        np.testing.assert_allclose(got[:, :nv], centred, atol=1e-5)

    @pytest.mark.parametrize("length", [None, 20000, 40000])
    def test_istft_matches_jax_and_golden(self, length):
        rng = np.random.default_rng(5)
        S = (rng.standard_normal((1025, 120)) + 1j * rng.standard_normal((1025, 120))
             ).astype(np.complex64)
        got = tstft.istft(torch.from_numpy(S), HOP, length=length).numpy()
        want = np.asarray(jstft.istft(jnp.asarray(S), HOP, length=length))
        golden = npref.istft(S.astype(np.complex128), HOP, length=length)
        # float32 FFT rounding on unit-variance bins: 1e-4 absolute
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_allclose(got, golden, atol=1e-4)

    def test_stft_istft_round_trip(self):
        y = _signal(235 * HOP, seed=7)  # a whole number of hops: exact inverse
        S = tstft.stft(torch.from_numpy(y), N_FFT, HOP)
        back = tstft.istft(S, HOP, length=len(y)).numpy()
        np.testing.assert_allclose(back, y, atol=1e-4)

    def test_dft_transform_is_not_ported(self):
        """The matmul-DFT transform is ported now (its parity with JAX is in
        tests/test_torch_port_dft.py); a transform neither "fft" nor "dft"
        is refused."""
        y = torch.from_numpy(np.random.default_rng(0).standard_normal(8192).astype(np.float32))
        fft = tstft.log_power_stft(y, transform="fft")
        dft = tstft.log_power_stft(y, transform="dft")
        assert dft.shape == fft.shape
        assert float((dft - fft).abs().max()) <= 1e-3
        with pytest.raises(ValueError, match="transform"):
            tstft.log_power_stft(y, transform="wavelet")


class TestGlueReference:
    """The glue's plain version against the JAX Pallas kernel, run in
    interpret mode as tests/test_pallas_kernels.py:118-132 runs it."""

    @pytest.mark.parametrize("nf", [64, 100])
    def test_matches_jax_pallas_glue(self, nf):
        rng = np.random.default_rng(nf)
        frames = rng.standard_normal((nf, N_FFT)).astype(np.float32)
        window, inv = _glue_consts(nf)
        want = np.asarray(jglue.gl_consistency_frames(
            jnp.asarray(frames), jnp.asarray(window), jnp.asarray(inv),
            t_tile=32, interpret=True))
        got = tglue.gl_consistency_frames(torch.from_numpy(frames), torch.from_numpy(window),
                                          torch.from_numpy(inv)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_ola_half_matches_jax_ola_kernel(self):
        """The first half (the CUDA gl_ola_nola's plain version) equals the
        y rows the Pallas _ola_kernel writes."""
        nf = 64
        rng = np.random.default_rng(11)
        frames = rng.standard_normal((nf, N_FFT)).astype(np.float32)
        window, inv = _glue_consts(nf)
        _, y_jax = jglue._glue_core(jnp.asarray(frames), jnp.asarray(window),
                                    jnp.asarray(inv), t_tile=32, interpret=True)
        y = tglue.ola_nola_reference(torch.from_numpy(frames), torch.from_numpy(window),
                                     torch.from_numpy(inv)).numpy()
        np.testing.assert_allclose(y, np.asarray(y_jax)[: nf + 7], atol=1e-5)

    def test_glue_equals_stft_of_istft(self):
        """rfft(glue(irfft S)) == stft(istft S) (test_pallas_kernels.py:134-150)."""
        nf = 40
        rng = np.random.default_rng(1)
        S = (rng.standard_normal((1025, nf)) + 1j * rng.standard_normal((1025, nf))
             ).astype(np.complex64)
        St = torch.from_numpy(S)
        want = tstft.stft(tstft.istft(St, HOP), N_FFT, HOP).numpy()
        window, inv = _glue_consts(nf)
        F = torch.fft.irfft(St.transpose(0, 1), n=N_FFT, dim=-1)
        G = tglue.gl_consistency_frames(F, torch.from_numpy(window), torch.from_numpy(inv))
        got = torch.fft.rfft(G, dim=-1).transpose(0, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


class TestGriffinLim:
    """Port griffinlim vs the JAX package's from one numpy phase: 8
    iterations, atol 1e-3 of the waveform's peak (float32 FFT rounding)."""

    def _magnitude(self, n=44100):
        y = _signal(n, seed=21)
        return np.abs(npref.stft(y.astype(np.float64), N_FFT, HOP)).astype(np.float32)

    @pytest.mark.parametrize("use_glue", [True, False])
    def test_matches_jax_from_shared_phase(self, use_glue):
        mag = self._magnitude()
        phase = (2 * np.pi * np.random.default_rng(3).random(mag.shape)).astype(np.float32)
        want = np.asarray(jgl.griffinlim(jnp.asarray(mag), n_iter=8, init_phase=jnp.asarray(phase),
                                         use_pallas_glue=False, transform="fft"))
        got = tgl.griffinlim(mag, n_iter=8, init_phase=phase, use_pallas_glue=use_glue,
                             device="cpu").numpy()
        assert got.shape == want.shape == (HOP * (mag.shape[1] - 1),)
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())

    def test_batched_runs_clip_by_clip(self):
        mag = self._magnitude(30000)
        batch = np.stack([mag, 0.5 * mag])
        gen = torch.Generator().manual_seed(4)
        out = tgl.griffinlim(batch, generator=gen, n_iter=2, device="cpu")
        gen = torch.Generator().manual_seed(4)
        first = tgl.griffinlim(mag, generator=gen, n_iter=2, device="cpu")
        assert out.shape == (2, HOP * (mag.shape[1] - 1))
        np.testing.assert_allclose(out[0].numpy(), first.numpy(), atol=1e-6)

    def test_glue_path_refuses_unsupported_options(self):
        """A ``length`` is an input the glue does not take: the default
        answers it on the istft -> stft loop (as the JAX package does), an
        explicit ``use_pallas_glue=True`` raises."""
        mag = self._magnitude(30000)
        length = HOP * (mag.shape[1] - 1) + 100  # keeps the frame count
        with pytest.raises(ValueError, match="use_pallas_glue=True"):
            tgl.griffinlim(mag, n_iter=1, length=length, use_pallas_glue=True, device="cpu")
        out = tgl.griffinlim(mag, n_iter=1, length=length, device="cpu")
        plain = tgl.griffinlim(mag, n_iter=1, length=length, use_pallas_glue=False, device="cpu")
        assert out.shape == (length,)
        assert torch.equal(out, plain)
