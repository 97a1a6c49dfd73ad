"""The port's autoencoder family against the JAX package's on the CPU:
``models/autoencoder.py`` (forward, ``mel_encode``, the spectral-loss train
step), ``train/losses.mel_multiscale_spectral_loss`` and
``ops/mel.mfcc_from_power``, at small widths and short T, float32 unless
stated, inputs from numpy seeds; tolerances stated per test. Weights cross
through ``compat/weights.from_jax_params(tree, AUTOENCODER)``."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.models import AutoencoderConfig as JConfig
from ml_music_style_transfer_tpu.models import SpectrogramAutoencoder as JAutoencoder
from ml_music_style_transfer_tpu.models import make_autoencoder_train_step as jmake
from ml_music_style_transfer_tpu.ops import mel as jmel
from ml_music_style_transfer_tpu.train import losses as jlosses
from ml_music_style_transfer_tpu_torch.compat import from_jax_params, to_jax_params
from ml_music_style_transfer_tpu_torch.compat.weights import AUTOENCODER
from ml_music_style_transfer_tpu_torch.models import (AutoencoderConfig, SpectrogramAutoencoder,
                                                      autoencoder, layers,
                                                      make_autoencoder_train_step)
from ml_music_style_transfer_tpu_torch.ops import mel
from ml_music_style_transfer_tpu_torch.scripts import bench_train
from ml_music_style_transfer_tpu_torch.train import losses


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Tier-1 runs six test workers on one machine: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(b=2, t=64, seed=1):
    """Log-power STFT frames in the pipeline's range, as the JAX test."""
    return (np.random.default_rng(seed).random((b, t, 1025)) * 3).astype(np.float32)


def _pair(n_bins, width, t, dtype="float32", seed=0):
    jcfg = JConfig(n_bins=n_bins, width=width, compute_dtype=dtype)
    params = jax.jit(JAutoencoder(jcfg).init)(jax.random.PRNGKey(seed), jnp.zeros((1, t, n_bins)))
    model = SpectrogramAutoencoder(AutoencoderConfig(n_bins=n_bins, width=width,
                                                     compute_dtype=dtype))
    model.load_state_dict(from_jax_params(jax.device_get(params), AUTOENCODER))
    return jcfg, params, model


def card_entry(x, dtype):
    """``layers.model_input`` as it runs on the card: the (B, C, T) view of
    a contiguous (B, T, C) tensor, so every block runs channel-last."""
    return layers.relayout(x.transpose(1, 2), dtype, False)


class TestModel:
    @pytest.mark.parametrize("entry", ["cpu", "card"])
    @pytest.mark.parametrize("n_bins,width,t", [(32, 16, 64), (128, 16, 32), (1025, 8, 16)])
    def test_forward_matches_jax(self, n_bins, width, t, entry, monkeypatch):
        """float32: within 1e-4 relative + 1e-5 of the output's peak, with
        the CPU's entry (channel-first) and the card's (channel-last)."""
        if entry == "card":
            monkeypatch.setattr(autoencoder, "model_input", card_entry)
        jcfg, params, model = _pair(n_bins, width, t)
        x = np.abs(np.random.default_rng(2).standard_normal((2, t, n_bins))).astype(np.float32)
        want = np.asarray(JAutoencoder(jcfg).apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.shape == want.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())

    def test_bf16_forward_is_as_close_to_jax_bf16_as_jax_bf16_is_to_float32(self):
        """bfloat16 compute rounds differently in the two frameworks: the
        port's bf16 output must sit no further from JAX's bf16 output than
        twice JAX's own bf16-vs-float32 distance (mean absolute)."""
        x = np.abs(np.random.default_rng(3).standard_normal((2, 64, 32))).astype(np.float32)
        jcfg, params, _ = _pair(32, 16, 64, dtype="bfloat16")
        j16 = np.asarray(JAutoencoder(jcfg).apply(params, jnp.asarray(x)))
        j32 = np.asarray(JAutoencoder(JConfig(32, 16, "float32")).apply(params, jnp.asarray(x)))
        model = SpectrogramAutoencoder(AutoencoderConfig(32, 16, "bfloat16"))
        model.load_state_dict(from_jax_params(jax.device_get(params), AUTOENCODER))
        with torch.no_grad():
            t16 = model(torch.from_numpy(x)).numpy()
        assert np.abs(t16 - j16).mean() <= 2 * np.abs(j16 - j32).mean()

    def test_key_map_round_trips(self):
        jcfg, params, model = _pair(32, 16, 64)
        tree = to_jax_params(model.state_dict(), AUTOENCODER)
        flat = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
        ours = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
            lambda t: t.numpy(), tree))
        assert [p for p, _ in flat] == [p for p, _ in ours]
        for (_, a), (_, b) in zip(flat, ours):
            np.testing.assert_array_equal(np.asarray(a), b)


class TestTrainStep:
    def test_mel_encode_matches_jax(self):
        """(B, T, 1025) log power -> (B, T, 32) log1p mel: within 1e-6 of the
        peak."""
        tr = jmake(JConfig(n_bins=32, width=16, compute_dtype="float32"))
        spec = _spec()
        want = np.asarray(tr.mel_encode(jnp.asarray(spec)))
        _, _, model = _pair(32, 16, 64)
        got = make_autoencoder_train_step(model).mel_encode(torch.from_numpy(spec)).numpy()
        assert got.shape == want.shape == (2, 64, 32) and np.all(got >= 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())

    def test_three_train_steps_match_jax(self):
        """The JAX test's configuration (n_bins 32, width 16, lr 3e-3, band
        scales 1, 2, 4): three steps of each package's train step from one
        init. Losses within 1e-5 relative; parameters within 5 % of their
        movement in L2 (Adam's first steps are about lr * sign(grad), so
        elements whose gradient sits at rounding level move opposite ways
        in any two float32 runs), and the loss falls."""
        jcfg, params, model = _pair(32, 16, 64)
        p0 = from_jax_params(jax.device_get(params), AUTOENCODER)
        jtr = jmake(jcfg, learning_rate=3e-3)
        opt = jtr.tx.init(params)
        ttr = make_autoencoder_train_step(model, learning_rate=3e-3)
        spec, w = _spec(), np.ones(2, np.float32)
        lj, lt = [], []
        for _ in range(3):
            params, opt, loss = jtr.step(params, opt, jnp.asarray(spec), jnp.asarray(w))
            lj.append(float(loss))
            lt.append(float(ttr.step(torch.from_numpy(spec), torch.from_numpy(w))))
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
        assert lt[-1] < lt[0]
        pj = from_jax_params(jax.device_get(params), AUTOENCODER)
        pt = model.state_dict()
        l2 = lambda a, b: sum(float(((a[k].double() - b[k].double()) ** 2).sum())  # noqa: E731
                              for k in a) ** 0.5
        assert l2(pt, pj) <= 0.05 * l2(pj, p0), (l2(pt, pj), l2(pj, p0))
        want = float(jtr.loss_fn(params, jtr.mel_encode(jnp.asarray(spec)), jnp.asarray(w)))
        got = float(ttr.loss_fn(ttr.mel_encode(torch.from_numpy(spec)), torch.from_numpy(w)))
        assert got == pytest.approx(want, rel=1e-4)


class TestMelLoss:
    @pytest.mark.parametrize("band_scales", [(1, 2, 4), (1,), (2, 8)])
    @pytest.mark.parametrize("weight", [[1.0, 1.0, 1.0], [1.0, 0.0, 0.5]])
    def test_matches_jax_with_the_weight_mask(self, band_scales, weight):
        """Within 1e-6 relative; a zero-weight item counts for nothing."""
        rng = np.random.default_rng(5)
        pred = (rng.random((3, 40, 64)) * 2).astype(np.float32)
        target = (rng.random((3, 40, 64)) * 2).astype(np.float32)
        w = np.asarray(weight, np.float32)
        want = float(jlosses.mel_multiscale_spectral_loss(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w), band_scales=band_scales))
        got = float(losses.mel_multiscale_spectral_loss(
            torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(w),
            band_scales=band_scales))
        assert got == pytest.approx(want, rel=1e-6)
        if weight[1] == 0.0:
            pred[1] += 5.0
            again = float(losses.mel_multiscale_spectral_loss(
                torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(w),
                band_scales=band_scales))
            assert again == pytest.approx(got, rel=1e-6)

    def test_indivisible_band_scale_raises_as_jax(self):
        x = np.zeros((1, 4, 30), np.float32)
        with pytest.raises(ValueError, match="not divisible by band scale 4"):
            jlosses.mel_multiscale_spectral_loss(jnp.asarray(x), jnp.asarray(x), jnp.ones(1))
        with pytest.raises(ValueError, match="not divisible by band scale 4"):
            losses.mel_multiscale_spectral_loss(torch.from_numpy(x), torch.from_numpy(x),
                                                torch.ones(1))


class TestMfcc:
    @pytest.mark.parametrize("shape,n_mfcc,n_mels", [((1025, 50), 20, 128), ((2, 1025, 30), 13, 64),
                                                     ((2, 3, 1025, 8), 40, 128)])
    def test_matches_jax(self, shape, n_mfcc, n_mels):
        """(..., bins, frames) power -> (..., n_mfcc, frames): within 1e-5 of
        the peak (float32 dB and DCT sums)."""
        power = (np.random.default_rng(6).random(shape) ** 4 * 100).astype(np.float32)
        want = np.asarray(jmel.mfcc_from_power(jnp.asarray(power), n_mfcc=n_mfcc, n_mels=n_mels))
        got = mel.mfcc_from_power(torch.from_numpy(power), n_mfcc=n_mfcc, n_mels=n_mels).numpy()
        assert got.shape == want.shape == shape[:-2] + (n_mfcc, shape[-1])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    def test_dct_matrix_is_the_jax_one_and_orthonormal(self):
        m = mel._dct_const(20, 128)
        np.testing.assert_array_equal(m, jmel._dct_const(20, 128))
        np.testing.assert_allclose(mel._dct_const(16, 16) @ mel._dct_const(16, 16).T, np.eye(16),
                                   atol=1e-6)

    def test_silence_floors_at_80_db_below_the_peak(self):
        power = np.zeros((1025, 4), np.float32)
        power[100, 0] = 1.0
        got = mel.mfcc_from_power(torch.from_numpy(power)).numpy()
        want = np.asarray(jmel.mfcc_from_power(jnp.asarray(power)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_bench_prints_the_autoencoder_metric():
    """``bench_train.py --model autoencoder --device cpu`` (small size)
    prints ``autoencoder_spectral_step_ms``."""
    out = subprocess.run([sys.executable, "-m", "ml_music_style_transfer_tpu_torch.scripts.bench_train",
                          "--model", "autoencoder", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    line = [x for x in out.stdout.splitlines() if x.startswith("metric autoencoder_spectral_step_ms=")]
    assert len(line) == 1 and "n_bins=128" in line[0]
    r = bench_train.autoencoder_step_ms(torch.device("cpu"), width=8, batch=1, t=16)
    assert r["ms"] > 0 and len(r["losses"]) == 14 and np.all(np.isfinite(r["losses"]))
