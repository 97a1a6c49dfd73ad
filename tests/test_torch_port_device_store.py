"""The port's device-resident store and resident training against the JAX
package on the CPU, at width 1/16 in float32: index plans, the on-device
batch gather, resident evaluation with JAX params carried across, the
resident step against the port's own host-fed step, ``fit`` and the train
CLI with ``--device-resident``, and what is refused. The same numpy-seeded
inputs go through both packages; tolerances are stated per test."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.config import TrainConfig as JTrainConfig
from ml_music_style_transfer_tpu.data import preprocess as jpp
from ml_music_style_transfer_tpu.data.device_store import DeviceDataStore as JDeviceDataStore
from ml_music_style_transfer_tpu.data.device_store import gather_batch as jgather_batch
from ml_music_style_transfer_tpu.testing import synthetic as jsynth
from ml_music_style_transfer_tpu.train.loop import Trainer as JTrainer
from ml_music_style_transfer_tpu_torch.compat import from_jax_params
from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.data import preprocess as pp
from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
from ml_music_style_transfer_tpu_torch.data.device_store import DeviceDataStore, gather_batch
from ml_music_style_transfer_tpu_torch.data.hdf5_store import load_dataset
from ml_music_style_transfer_tpu_torch.train import cli as train_cli
from ml_music_style_transfer_tpu_torch.train.loop import Trainer

TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32")
STYLES = ["cuba", "upright"]
# jnp.fft against torch.fft in float32 on one chunk, in log space (each is
# ~2e-6 from the other, ~2e-4 from the float64 reference)
STFT_ATOL = 5e-5
# the forward agrees within 1e-4 relative + 1e-4 of the peak
# (test_torch_port_model.py); a mean of squared errors of such outputs
# agrees within 1e-3 relative
EVAL_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads per module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A train split of 5 chunks (2 songs) and a test split of 2 (1 song),
    preprocessed by the JAX package with audio stored; the same with a test
    split without audio; and the train split preprocessed by the port."""
    root = tmp_path_factory.mktemp("resident")
    jsynth.make_dataset_dir(str(root / "raw"), song_ids=[1, 2, 3], styles=STYLES, duration=16.0,
                            seed=5, normalize="rms")
    kw = dict(styles=STYLES, store_audio=True, stft_backend="device")
    jpp.get_data(str(root / "raw"), str(root / "ds"), "train", song_ids=[1, 2], **kw)
    jpp.get_data(str(root / "raw"), str(root / "ds"), "test", song_ids=[3], **kw)
    os.makedirs(root / "noaudio")
    jpp.get_data(str(root / "raw"), str(root / "noaudio" / "ds"), "train", song_ids=[1, 2], **kw)
    jpp.get_data(str(root / "raw"), str(root / "noaudio" / "ds"), "test", song_ids=[3],
                 styles=STYLES, stft_backend="device")
    port = pp.get_data(str(root / "raw"), str(root / "port"), "train", song_ids=[1, 2],
                       device="cpu", **kw)
    return str(root / "ds"), str(root / "noaudio" / "ds"), port


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestStore:
    def test_index_plans_equal_jax(self, data):
        """One seed draws the same (idx, cond_idx, style) in both packages,
        epoch after epoch, and the same evaluation plan."""
        path = data[0] + "_train.hdf5"
        port = DeviceDataStore(path, seed=7, audio_dtype=torch.float32, device="cpu")
        jax_store = JDeviceDataStore(path, seed=7, audio_dtype=jnp.float32)
        for _ in range(3):
            for shuffle in (True, False):
                got = list(port.draw_epoch_indices(2, shuffle=shuffle))
                want = list(jax_store.draw_epoch_indices(2, shuffle=shuffle))
                assert len(got) == len(want) == port.n_data // 2 > 0
                for g, w in zip(got, want):
                    for a, b in zip(g, w):
                        np.testing.assert_array_equal(_np(a), _np(b))
                        assert a.dtype == torch.int64
        for g, w in zip(port.eval_epoch_indices(3), jax_store.eval_epoch_indices(3)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(_np(a), _np(b))

    def test_layout_and_dtypes(self, data):
        store = DeviceDataStore(data[0] + "_train.hdf5", device="cpu")
        n = store.n_data
        assert store.styles == STYLES and n == 5
        assert store.audio.shape == (2, n, 219904) and store.audio.dtype == torch.bfloat16
        assert store.pianoroll.dtype == store.onoff.dtype == torch.int8
        assert store.hbm_bytes() == 2 * n * 219904 * 2 + 2 * n * 860 * 128
        raw = load_dataset(data[0] + "_train.hdf5", include_specs=False)
        same = DeviceDataStore.from_arrays(raw, device="cpu")
        assert torch.equal(same.audio, store.audio) and torch.equal(same.onoff, store.onoff)

    def test_gather_batch_matches_jax(self, data):
        path = data[0] + "_train.hdf5"
        port = DeviceDataStore(path, audio_dtype=torch.float32, device="cpu")
        js = JDeviceDataStore(path, audio_dtype=jnp.float32)
        idx, cond_idx, style = np.array([0, 4, 1]), np.array([2, 2, 0]), np.array([1, 0, 1])
        want = jgather_batch(js.audio, js.pianoroll, js.onoff, jnp.asarray(idx),
                             jnp.asarray(cond_idx), jnp.asarray(style))
        got = gather_batch(port.audio, port.pianoroll, port.onoff, *map(torch.from_numpy,
                                                                       (idx, cond_idx, style)))
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=STFT_ATOL)
        # and against the host batch of the stored spectrograms (same STFT)
        ds = ChunkDataset(path)
        for j in range(3):
            np.testing.assert_allclose(got["target"][j].numpy(),
                                       ds.specs[f"spec_{STYLES[style[j]]}"][idx[j]],
                                       rtol=0, atol=STFT_ATOL)

    def test_refusals(self, data, tmp_path):
        path = data[0] + "_train.hdf5"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceDataStore(path)
        with pytest.raises(NotImplementedError, match="item 9"):
            DeviceDataStore(path, store_sharding="data", device="cpu")
        with pytest.raises(NotImplementedError, match="item 9"):
            DeviceDataStore(path, mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="store-audio"):
            DeviceDataStore(data[1] + "_test.hdf5", device="cpu")
        raw = load_dataset(path, include_specs=False)
        raw["audio_cuba"] = raw["audio_cuba"][:4]
        with pytest.raises(ValueError, match="misaligned"):
            DeviceDataStore.from_arrays(raw, device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    tr = JTrainer(JModelConfig(**TINY_KW), JTrainConfig(batch_size=3), use_native_loader=False)
    params, _ = tr.init_state(3)
    return tr, params


class TestResidentTraining:
    def test_evaluate_resident_matches_jax(self, data, jax_params):
        """Resident MSE over the padded plan (2 chunks, batch 3), with JAX's
        params carried across, within EVAL_RTOL; repeated calls agree."""
        jtr, params = jax_params
        path = data[0] + "_test.hdf5"
        want = jtr.evaluate_resident(JDeviceDataStore(path, seed=4, audio_dtype=jnp.float32),
                                     params)
        tr = Trainer(ModelConfig(**TINY_KW), TrainConfig(batch_size=3), device="cpu")
        tr.init_state(0)
        tr.model.load_state_dict(from_jax_params(jax.device_get(params)))
        store = DeviceDataStore(path, seed=4, audio_dtype=torch.float32, device="cpu")
        got = tr.evaluate_resident(store)
        assert got == tr.evaluate_resident(store)
        np.testing.assert_allclose(got, want, rtol=EVAL_RTOL)

    def test_resident_step_equals_host_fed_step(self, data):
        """Same indices, same dropout seed (dropout on), float32: the
        resident step and the host-fed step leave the same loss and the same
        weights, bit for bit: the port preprocessed the file, so the stored
        spectrograms are the STFT that the gather computes."""
        path = data[2]
        store = DeviceDataStore(path, audio_dtype=torch.float32, device="cpu")
        ds = ChunkDataset(path)
        idx, cond_idx, style = np.array([2, 0]), np.array([1, 3]), np.array([0, 1])
        host = {"midi": ds.pianoroll[idx], "onoff": ds.onoff[idx],
                "target": np.stack([ds.specs[ds.styles[s]][i] for i, s in zip(idx, style)]),
                "cond": np.stack([ds.specs[ds.styles[s]][i] for i, s in zip(cond_idx, style)]),
                "weight": np.ones(2, np.float32)}
        trainers = []
        for _ in range(2):
            tr = Trainer(ModelConfig(**TINY_KW), TrainConfig(batch_size=2), device="cpu")
            tr.init_state(0)
            trainers.append(tr)
        a = trainers[0].train_step_resident(store.audio, store.pianoroll, store.onoff,
                                            *map(torch.from_numpy, (idx, cond_idx, style)), 99)
        b = trainers[1].train_step({k: torch.from_numpy(v) for k, v in host.items()}, 99)
        assert float(a) == float(b)
        for (k, p), q in zip(trainers[0].model.state_dict().items(),
                             trainers[1].model.state_dict().values()):
            assert torch.equal(p, q), k

    def test_fit_device_resident_then_resume(self, data, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        cfg = TrainConfig(epochs=2, exp_name="r", batch_size=8)  # clamps to the 5 chunks
        _, exp = Trainer(ModelConfig(**TINY_KW), cfg, device="cpu").fit(
            data[0], device_resident=True, device_audio_dtype=torch.float32)
        out = capsys.readouterr().out
        assert "clamping to 5" in out and "(device-resident)" in out
        assert len(exp.loss_history) == 2 and np.isfinite(exp.loss_history).all()
        with open(os.path.join("experiments", "r", "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        assert all(e["device_resident"] for e in events if e["event"] == "train_epoch")
        tr = Trainer(ModelConfig(**TINY_KW), TrainConfig(epochs=3, exp_name="r", batch_size=4),
                     device="cpu")
        _, exp = tr.fit(data[0], resume=True, device_resident=True)
        assert len(exp.loss_history) == 3

    def test_test_split_without_audio_is_evaluated_from_host_batches(self, data, tmp_path,
                                                                      monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        _, exp = Trainer(ModelConfig(**TINY_KW), TrainConfig(exp_name="h", batch_size=2),
                         device="cpu").fit(data[1], device_resident=True)
        out = capsys.readouterr().out
        assert "evaluating via the host-streamed path" in out
        assert len(exp.test_loss_history) == 1 and np.isfinite(exp.test_loss_history[0])

    def test_cli_device_resident(self, data, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        train_cli.main(["-data-dir", data[0], "-exp-name", "c", "--batch-size", "2",
                        "--width-mult", str(1 / 16), "--device-resident", "--device", "cpu"])
        assert os.path.exists(os.path.join("experiments", "c", "checkpoint-1.pt"))
        with pytest.raises(NotImplementedError, match="item 9"):
            train_cli.main(["-data-dir", data[0], "-exp-name", "d", "--device-resident",
                            "--store-sharding", "data", "--device", "cpu"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["-data-dir", data[0], "-exp-name", "e", "--device-resident"])
