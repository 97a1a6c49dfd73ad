"""Parity repairs against the JAX package, on the CPU: the STFT at hops
that do not divide ``n_fft`` (gather framing, ``n_frames_for``), checkpoint
resolution over a directory that mixes formats (``latest_checkpoint``,
``best_checkpoint``), and two helpers the port lacked:
``data/fastloader.available`` and ``parallel/mesh.per_device_param_bytes``
(on two gloo ranks, against the JAX function on its virtual mesh)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_parallel_workers as W
from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.data import fastloader as jfastloader
from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
from ml_music_style_transfer_tpu.ops import stft as jstft
from ml_music_style_transfer_tpu.parallel import mesh as jmesh
from ml_music_style_transfer_tpu.train import checkpoint as jckpt
from ml_music_style_transfer_tpu_torch.data import fastloader
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.parallel import launch
from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt


def _signal():
    return np.random.default_rng(20).standard_normal(20_000).astype(np.float32)


class TestStftAtOtherHops:
    @pytest.mark.parametrize("hop", [300, 384])
    @pytest.mark.parametrize("transform", ["fft", "dft"])
    def test_log_power_stft_matches_jax(self, hop, transform):
        """Gather framing where the hop does not divide 2048: 1e-4 of the
        peak (float32 transforms in another order)."""
        y = _signal()
        want = np.asarray(jstft.log_power_stft(jnp.asarray(y), 2048, hop, transform=transform))
        got = tstft.log_power_stft(torch.from_numpy(y), 2048, hop, transform=transform).numpy()
        assert got.shape == want.shape == (1025, jstft.n_frames_for(20_000, hop))
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())

    @pytest.mark.parametrize("hop", [300, 384])
    def test_stft_matches_jax(self, hop):
        y = _signal()
        want = np.asarray(jstft.stft(jnp.asarray(y), 2048, hop))
        got = tstft.stft(torch.from_numpy(y), 2048, hop).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())

    def test_frame_count_contract(self):
        assert tstft.stft(torch.from_numpy(_signal()), 2048, 300).shape == (1025, 67)
        for n, hop in ((20_000, 300), (219_904, 256), (44_100, 384)):
            assert tstft.n_frames_for(n, hop) == jstft.n_frames_for(n, hop)
        for mod in (tstft, jstft):
            with pytest.raises(NotImplementedError):
                mod.n_frames_for(100, 10, center=False)

    def test_overlap_add_still_refuses_such_hops(self):
        """As JAX's: the dense overlap-add needs the hop to divide n_fft."""
        S = torch.zeros((1025, 10), dtype=torch.complex64)
        with pytest.raises(NotImplementedError, match="hop must divide"):
            tstft.istft(S, 300)
        with pytest.raises(NotImplementedError, match="hop must divide"):
            jstft.istft(jnp.zeros((1025, 10), jnp.complex64), 300)


def _mixed_dir(root, best_epoch=5):
    """checkpoint-3.msgpack and checkpoint-5.orbax, both written by the JAX
    package, and hyperparams with ``best_epoch``."""
    d = str(root)
    os.makedirs(d, exist_ok=True)
    jckpt.save_checkpoint(d, 3, {"epoch": 3})
    jckpt.save_checkpoint_sharded(d, 5, {"epoch": 5, "w": np.arange(6, dtype=np.float32)},
                                  wait=True)
    exp = jckpt.ExperimentState(5, 1, "x")
    exp.best_epoch = best_epoch
    exp.save(d)
    return d


class TestMixedCheckpointDirectories:
    @pytest.mark.parametrize("fn", ["latest_checkpoint", "best_checkpoint"])
    def test_an_orbax_answer_raises(self, fn, tmp_path, capsys):
        """Where JAX answers the orbax checkpoint, the port answers it too
        (it used to raise, before orbax directories were read), with no
        false "missing" warning and no fall-back to the older msgpack, and
        reads it as JAX restores it."""
        d = _mixed_dir(tmp_path)
        want = (os.path.join(d, "checkpoint-5.orbax"), 5)
        assert getattr(jckpt, fn)(d) == getattr(ckpt, fn)(d) == want
        assert "missing" not in capsys.readouterr().out
        got = ckpt.restore_checkpoint(want[0])
        jax_got = jckpt.restore_checkpoint_sharded_host(want[0])
        assert got["epoch"] == jax_got["epoch"] == 5
        assert np.array_equal(got["w"].numpy(), jax_got["w"])

    def test_a_readable_answer_is_the_jax_answer(self, tmp_path):
        """best_epoch 3: both answer the msgpack; a newer msgpack beside an
        orbax of its epoch wins the tie, as in JAX."""
        d = _mixed_dir(tmp_path, best_epoch=3)
        want = (os.path.join(d, "checkpoint-3.msgpack"), 3)
        assert jckpt.best_checkpoint(d) == ckpt.best_checkpoint(d) == want
        jckpt.save_checkpoint(d, 5, {"epoch": 5})
        want = (os.path.join(d, "checkpoint-5.msgpack"), 5)
        assert jckpt.latest_checkpoint(d) == ckpt.latest_checkpoint(d) == want


class TestHelpers:
    def test_fastloader_available_where_it_builds(self):
        """The assembler builds here (g++), so both packages say so; the
        port's answer is its build, not a fallback."""
        assert fastloader.available() is True
        assert jfastloader.available() is True

    def test_fastloader_unavailable_when_the_build_fails(self, monkeypatch):
        def broken():
            raise RuntimeError("host library build failed")

        monkeypatch.setattr(fastloader, "_lib", broken)
        assert fastloader.available() is False
        with pytest.raises(RuntimeError, match="build failed"):
            fastloader.NativeBatchAssembler(None, 2)

    def test_per_device_param_bytes_matches_jax(self):
        """Two gloo ranks of a (1, 2) mesh against the JAX function on two
        virtual devices: the same (per-device, total) bytes, whole and
        tensor-parallel; a DTensor counts its shard."""
        if len(jax.devices()) < 2:
            pytest.skip("needs the virtual CPU mesh (tests/conftest.py)")
        out = launch.spawn(W.param_bytes, 2, (), device="cpu")
        mesh = jmesh.make_mesh(1, 2, devices=jax.devices()[:2])
        z = jnp.zeros((1, 220, 128))
        shapes = jax.eval_shape(JPerformanceNet(JModelConfig(**W.TINY_KW)).init,
                                jax.random.PRNGKey(0), z, jnp.zeros((1, 220, 1025)), z)
        params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        per, total = jmesh.per_device_param_bytes(jmesh.shard_params(params, mesh))
        for rank in out:
            assert rank["whole"] == (total, total)
            assert rank["tp"] == (per, total)
            assert rank["dtensor"] == (3 * 4 * 4 + 12, 6 * 4 * 4 + 12)
        assert per < total
