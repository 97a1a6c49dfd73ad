"""The port's losses, mel filterbank and LR scheduler against the JAX
package on the CPU. Inputs come from numpy seeds and go through both;
tolerances are stated per test."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.ops import mel as jmel
from ml_music_style_transfer_tpu.ops import reference as jref
from ml_music_style_transfer_tpu.train import losses as jlosses
from ml_music_style_transfer_tpu.train.schedule import ReduceLROnPlateau as JReduceLROnPlateau
from ml_music_style_transfer_tpu_torch.ops import mel as tmel
from ml_music_style_transfer_tpu_torch.ops import reference as tref
from ml_music_style_transfer_tpu_torch.train import losses as tlosses
from ml_music_style_transfer_tpu_torch.train.schedule import ReduceLROnPlateau

# float32 sums taken in another order by XLA and ATen: 1e-5 relative
RTOL = 1e-5


def _pair(b=4, t=64, bins=1025, seed=0, hi=6.0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.5, hi, (b, t, bins)).astype(np.float32)
    target = rng.uniform(0.0, hi, (b, t, bins)).astype(np.float32)
    return pred, target


WEIGHTS = {"all": np.ones(4, np.float32), "padded": np.array([1, 1, 1, 0], np.float32)}


class TestPointLosses:
    @pytest.mark.parametrize("name", ["l1_loss", "mse_loss"])
    @pytest.mark.parametrize("weight", ["all", "padded"])
    def test_matches_jax(self, name, weight):
        pred, target = _pair(seed=1)
        w = WEIGHTS[weight]
        want = float(getattr(jlosses, name)(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w)))
        got = float(getattr(tlosses, name)(torch.from_numpy(pred), torch.from_numpy(target),
                                           torch.from_numpy(w)))
        assert got == pytest.approx(want, rel=RTOL)

    def test_padded_items_drop_exactly(self):
        pred, target = _pair(seed=2)
        w = torch.from_numpy(WEIGHTS["padded"])
        full = tlosses.mse_loss(torch.from_numpy(pred), torch.from_numpy(target), w)
        real = tlosses.mse_loss(torch.from_numpy(pred[:3]), torch.from_numpy(target[:3]),
                                torch.ones(3))
        assert float(full) == pytest.approx(float(real), rel=1e-6)


class TestSpectralLoss:
    @pytest.mark.parametrize("mode", ["linlog", "log", "direct"])
    @pytest.mark.parametrize("weight", ["all", "padded"])
    def test_matches_jax(self, mode, weight):
        pred, target = _pair(t=48, seed=3)
        w = WEIGHTS[weight]
        want = float(jlosses.multiscale_spectral_loss(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w), mode=mode))
        got = float(tlosses.multiscale_spectral_loss(
            torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(w), mode=mode))
        assert got == pytest.approx(want, rel=RTOL)

    def test_gradient_matches_jax(self):
        """1e-4 of the gradient's peak: the backward adds the mel matmuls'
        transposes and expm1's derivative to the forward's rounding."""
        pred, target = _pair(b=2, t=16, seed=4, hi=3.0)
        w = np.ones(2, np.float32)
        want = np.asarray(jax.grad(lambda p: jlosses.multiscale_spectral_loss(
            p, jnp.asarray(target), jnp.asarray(w)))(jnp.asarray(pred)))
        p = torch.from_numpy(pred).requires_grad_()
        tlosses.multiscale_spectral_loss(p, torch.from_numpy(target), torch.from_numpy(w)).backward()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())

    @pytest.mark.parametrize("mode", ["linlog", "log", "direct"])
    def test_finite_gradient_on_out_of_domain_pred(self, mode):
        """As tests/test_losses.py: spikes past expm1's float32 range, exact
        zeros and leaky-ReLU negatives must leave the gradient finite."""
        rng = np.random.default_rng(5)
        target = (rng.random((2, 16, 1025)) * 3).astype(np.float32)
        pred = target.copy()
        pred[0, 0, :10] = 120.0
        pred[0, 1, :100] = 0.0
        pred[0, 2, :100] = -0.3
        p = torch.from_numpy(pred).requires_grad_()
        loss = tlosses.multiscale_spectral_loss(p, torch.from_numpy(target), torch.ones(2),
                                                mode=mode)
        loss.backward()
        assert torch.isfinite(loss) and bool(torch.isfinite(p.grad).all())

    def test_unknown_mode_raises(self):
        pred, target = _pair(b=1, t=4, seed=6)
        with pytest.raises(ValueError, match="mode"):
            tlosses.multiscale_spectral_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                             torch.ones(1), mode="mystery")


class TestMel:
    @pytest.mark.parametrize("n_mels", [512, 256, 128, 64])
    def test_filterbank_matches_jax(self, n_mels):
        """1e-6 absolute: the same float64 construction rounded to float32."""
        want = np.asarray(jmel.mel_filterbank(44100, 2048, n_mels))
        got = tmel.mel_filterbank(44100, 2048, n_mels).numpy()
        assert got.shape == want.shape == (n_mels, 1025) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    def test_mel_scale_matches_jax(self):
        f = np.linspace(0, 22050, 1001)
        np.testing.assert_array_equal(tref.hz_to_mel(f), jref.hz_to_mel(f))
        m = tref.hz_to_mel(f)
        np.testing.assert_array_equal(tref.mel_to_hz(m), jref.mel_to_hz(m))
        np.testing.assert_array_equal(tref.hz_to_mel(f, htk=True), jref.hz_to_mel(f, htk=True))

    def test_melspectrogram_matches_jax(self):
        rng = np.random.default_rng(7)
        power = rng.random((2, 1025, 40)).astype(np.float32) * 10
        want = np.asarray(jmel.melspectrogram_from_power(jnp.asarray(power), n_mels=128))
        got = tmel.melspectrogram_from_power(torch.from_numpy(power), n_mels=128).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


class TestScheduler:
    METRICS = list(1.0 - 0.01 * np.arange(5)) + [0.96] * 30 + [0.5] + [0.5] * 15

    def test_matches_jax_and_torch_exactly(self):
        lin = torch.nn.Linear(1, 1)
        opt = torch.optim.Adam(lin.parameters(), lr=1e-3)
        tsched = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, "min")
        ours, jax_ = ReduceLROnPlateau(lr=1e-3), JReduceLROnPlateau(lr=1e-3)
        drops = 0
        for m in self.METRICS:
            tsched.step(m)
            lr = ours.step(m)
            assert lr == jax_.step(m) == opt.param_groups[0]["lr"], m
            assert ours.state_dict() == jax_.state_dict()
            drops += lr < 1e-3
        assert drops > 0  # the sequence does reach a plateau drop

    def test_state_dict_round_trips_with_the_jax_scheduler(self):
        ours = ReduceLROnPlateau(lr=1e-3)
        for m in self.METRICS[:20]:
            ours.step(m)
        other = JReduceLROnPlateau(lr=5.0)
        other.load_state_dict(ours.state_dict())
        back = ReduceLROnPlateau(lr=0.0)
        back.load_state_dict(other.state_dict())
        assert back == ours
