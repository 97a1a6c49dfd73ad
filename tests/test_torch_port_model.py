"""The port's PerformanceNet and weight conversion against the JAX package
on the CPU, at width 1/16 in float32 (3,338,617 params), plus a full-width
build on the meta device. Inputs come from numpy seeds and go through both
packages; tolerances are stated per test."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.compat import save_reference_checkpoint
from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
from ml_music_style_transfer_tpu.models import forward_channel_first as jforward_cf
from ml_music_style_transfer_tpu.models import layers as jlayers
from ml_music_style_transfer_tpu.models import temporal_ladder as jladder
from ml_music_style_transfer_tpu_torch.compat import from_jax_params, load_reference_checkpoint
from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.infer.synthesize import build_model
from ml_music_style_transfer_tpu_torch.models import PerformanceNet, forward_channel_first, temporal_ladder
from ml_music_style_transfer_tpu_torch.models import layers, performance_net

TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32")
FULL_WIDTH_PARAMS = 731_945_857  # jax.eval_shape of the JAX model, default config
TINY_PARAMS = 3_338_617
# float32 on the CPU. XLA and ATen sum each convolution in another order,
# and the ~30 conv + InstanceNorm layers grow that rounding to about 1e-4
# of the output's peak in both frameworks alike (each is that far from a
# float64 evaluation of the same net). So: 1e-4 relative, plus 1e-4 of the
# peak absolute.
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Tier-1 runs six test workers on one machine; torch's default of one
    thread per core oversubscribes it (a train step here ran 10x slower),
    so this module's torch ops use two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4 * np.abs(want).max())


def _inputs(batch=2, t=860, seed=0):
    rng = np.random.default_rng(seed)
    midi = (rng.random((batch, t, 128)) < 0.05).astype(np.float32)
    onoff = rng.integers(-1, 2, (batch, t, 128)).astype(np.float32)
    spec = rng.uniform(0.0, 4.0, (batch, t, 1025)).astype(np.float32)
    return midi, spec, onoff


def _flax_params(compat=False, seed=0):
    model = JPerformanceNet(JModelConfig(compat_mbr_noop=compat, **TINY_KW))
    midi, spec, onoff = _inputs(batch=1, t=860)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(midi), jnp.asarray(spec),
                        jnp.asarray(onoff))
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def flax_model():
    return _flax_params()


def card_entry(x, dtype):
    """``layers.model_input`` as it runs on the card: the (B, C, T) view of
    a contiguous (B, T, C) tensor, so every block runs channel-last."""
    return layers.relayout(x.transpose(1, 2), dtype, False)


class TestForwardParity:
    @pytest.mark.parametrize("entry", ["cpu", "card"])
    @pytest.mark.parametrize("compat", [False, True])
    def test_forward_matches_jax(self, compat, entry, monkeypatch):
        """With the CPU's entry (channel-first) and the card's (channel-last
        memory throughout)."""
        if entry == "card":
            monkeypatch.setattr(performance_net, "model_input", card_entry)
        jmodel, params = _flax_params(compat=compat, seed=1)
        cfg = ModelConfig(compat_mbr_noop=compat, **TINY_KW)
        model = build_model(cfg, from_jax_params(params), "cpu")
        midi, spec, onoff = _inputs()
        want = np.asarray(jmodel.apply(params, midi, spec, onoff))
        with torch.no_grad():
            got = model(torch.from_numpy(midi), torch.from_numpy(spec),
                        torch.from_numpy(onoff)).numpy()
        assert got.shape == want.shape == (2, 860, 1025) and got.dtype == np.float32
        _assert_close(got, want)

    def test_channel_first_adapter_matches_jax(self, flax_model):
        jmodel, params = flax_model
        model = build_model(ModelConfig(**TINY_KW), from_jax_params(params), "cpu")
        midi, spec, onoff = (a.transpose(0, 2, 1).copy() for a in _inputs(batch=1, seed=4))
        want = np.asarray(jforward_cf(jmodel, params, midi, spec, onoff))
        with torch.no_grad():
            got = forward_channel_first(model, *map(torch.from_numpy, (midi, spec, onoff))).numpy()
        assert got.shape == (1, 1025, 860)
        _assert_close(got, want)

    def test_bf16_forward_matches_jax_bf16(self, flax_model):
        """The card serves the bfloat16 default (``compute_dtype``), and bf16
        rounds at other places in XLA and ATen. So the two bf16 forwards,
        JAX params carried across, are held to the distance bf16 itself puts
        between JAX's bf16 and float32 forwards (width 1/16, T = 860, batch
        1, output peak 4.76; measured: mean |port - JAX| 0.049 against JAX's
        bf16-vs-f32 0.081, and the port's own bf16-vs-f32 0.082):
          - mean |port_bf16 - jax_bf16| <= mean |jax_bf16 - jax_f32|;
          - mean |port_bf16 - port_f32| <= 1.25 x mean |jax_bf16 - jax_f32|."""
        jmodel, params = flax_model
        midi, spec, onoff = _inputs(batch=1)
        jbf16 = JPerformanceNet(JModelConfig(width_mult=1 / 16, compute_dtype="bfloat16"))
        j32 = np.asarray(jmodel.apply(params, midi, spec, onoff), np.float64)
        j16 = np.asarray(jbf16.apply(params, midi, spec, onoff), np.float64)
        outs = {}
        for dtype in ("float32", "bfloat16"):
            model = build_model(ModelConfig(width_mult=1 / 16, compute_dtype=dtype),
                                from_jax_params(params), "cpu")
            with torch.no_grad():
                outs[dtype] = model(*map(torch.from_numpy, (midi, spec, onoff))).double().numpy()
        p16, p32 = outs["bfloat16"], outs["float32"]
        jax_gap = np.abs(j16 - j32).mean()
        assert 0.0 < jax_gap and np.isfinite(p16).all() and p16.shape == j16.shape
        assert np.abs(p16 - j16).mean() <= jax_gap
        assert np.abs(p16 - p32).mean() <= 1.25 * jax_gap

    def test_training_forward_waits_for_the_training_slice(self, flax_model):
        """The training slice has landed: a training forward needs a
        dropout seed, is reproducible from it, and drops activations."""
        model = build_model(ModelConfig(**TINY_KW), from_jax_params(flax_model[1]), "cpu")
        midi, spec, onoff = map(torch.from_numpy, _inputs(batch=1))
        with pytest.raises(ValueError, match="dropout_seed"):
            model(midi, spec, onoff, deterministic=False)
        with torch.no_grad():
            a = model(midi, spec, onoff, deterministic=False, dropout_seed=5)
            b = model(midi, spec, onoff, deterministic=False, dropout_seed=5)
            c = model(midi, spec, onoff, deterministic=False, dropout_seed=6)
            ref = model(midi, spec, onoff)
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
        assert not torch.equal(a, c) and not torch.equal(a, ref)


class TestShapes:
    def test_full_width_param_count_on_meta(self):
        model = PerformanceNet(ModelConfig(), device="meta")
        assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH_PARAMS
        assert all(p.device.type == "meta" for p in model.parameters())

    def test_tiny_param_count_matches_flax(self, flax_model):
        model = PerformanceNet(ModelConfig(**TINY_KW), device="cpu")
        flax_count = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(flax_model[1]))
        assert sum(p.numel() for p in model.parameters()) == flax_count == TINY_PARAMS

    def test_temporal_ladder(self):
        assert temporal_ladder() == jladder() == {
            "encoder": [860, 430, 215, 107, 53], "decoder": [53, 108, 216, 431, 860]}

    def test_decoder_ladder_in_the_model(self):
        """The up-convs lift 53 -> 108 -> 216 -> 431 -> 860 at full width's
        plan, run at width 1/16."""
        model = PerformanceNet(ModelConfig(**TINY_KW), device="cpu")
        seen = []
        for up in model.up_convs:
            up.register_forward_hook(lambda m, i, o: seen.append(o.shape[-1]))
        with torch.no_grad():
            out = model(*map(torch.from_numpy, _inputs(batch=1)))
        assert seen == [108, 216, 431, 860] and out.shape == (1, 860, 1025)

    def test_init_is_seeded_xavier_with_zero_bias(self):
        a = PerformanceNet(ModelConfig(**TINY_KW), generator=torch.Generator().manual_seed(3))
        b = PerformanceNet(ModelConfig(**TINY_KW), generator=torch.Generator().manual_seed(3))
        for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(pa, pb), name
            if name.endswith(".bias"):
                assert not pa.any(), name
        w = a.down_convs_audio[0].conv1.weight  # (out, in, k)
        fan = (w.shape[0] + w.shape[1]) * w.shape[2]
        assert abs(float(w.detach().std()) - (2.0 / fan) ** 0.5) < 0.05 * (2.0 / fan) ** 0.5


class TestLayers:
    @pytest.mark.parametrize("t_up,t_by", [(108, 107), (216, 215), (431, 430), (860, 860),
                                           (100, 104), (100, 105)])
    def test_crop_and_concat_matches_jax(self, t_up, t_by):
        rng = np.random.default_rng(t_up + t_by)
        up = rng.standard_normal((2, t_up, 3)).astype(np.float32)
        by = rng.standard_normal((2, t_by, 5)).astype(np.float32)
        want = np.asarray(jlayers.crop_and_concat(jnp.asarray(up), jnp.asarray(by)))
        got = layers.crop_and_concat(torch.from_numpy(up).transpose(1, 2),
                                     torch.from_numpy(by).transpose(1, 2))
        np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)

    def test_instance_norm_matches_jax(self):
        x = (np.random.default_rng(0).standard_normal((2, 50, 7)) * 3 + 1).astype(np.float32)
        want = np.asarray(jlayers.instance_norm(jnp.asarray(x)))
        got = layers.instance_norm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    def test_instance_norm_keeps_bf16_with_f32_statistics(self):
        x = torch.randn(2, 4, 64, generator=torch.Generator().manual_seed(0)) * 50 + 300
        got = layers.instance_norm(x.bfloat16())
        assert got.dtype == torch.bfloat16
        want = layers.instance_norm(x.bfloat16().float())
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2)


class TestWeights:
    def test_reference_tar_round_trip_strict(self, flax_model, tmp_path):
        """JAX save_reference_checkpoint -> port load_reference_checkpoint ->
        load_state_dict(strict=True), same forward as the direct conversion."""
        jmodel, params = flax_model
        path = save_reference_checkpoint(str(tmp_path / "checkpoint-3.tar"), params, epoch=3)
        state = load_reference_checkpoint(path)
        direct = from_jax_params(params)
        assert state.keys() == direct.keys()
        model = PerformanceNet(ModelConfig(**TINY_KW), device="meta")
        model.load_state_dict(state, strict=True, assign=True)
        for k, v in model.state_dict().items():
            assert torch.equal(v, direct[k]), k

    def test_compat_drops_dead_mbr_weights(self, flax_model, tmp_path):
        path = save_reference_checkpoint(str(tmp_path / "c.tar"), flax_model[1])
        state = load_reference_checkpoint(path, compat_mbr_noop=True)
        assert not any(k.startswith("MBRBlock") for k in state)
        model = build_model(ModelConfig(compat_mbr_noop=True, **TINY_KW), state, "cpu")
        assert model.MBRBlock1.compat_noop

    def test_unmapped_flax_module_raises(self):
        with pytest.raises(KeyError, match="unmapped"):
            from_jax_params({"params": {"mystery": {"kernel": np.zeros((2, 2)),
                                                    "bias": np.zeros(2)}}})
