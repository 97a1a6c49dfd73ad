"""The port's native batch assembler (``csrc/fastloader.cpp`` through
``data/fastloader.py``) against the JAX package's
(``native/fastloader/libfastloader.so``, built by its Makefile) on the CPU:
bit-equal batches for the same submissions, the same epoch plan from the
same RNG state, the slot ring, bounds, the host build route (g++, no nvcc),
and the Trainer's native path. Both assemblers copy float32 rows, so every
comparison is exact."""
import os
import shutil

import numpy as np
import pytest
import torch

from ml_music_style_transfer_tpu.data import fastloader as jfastloader
from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.data import fastloader
from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
from ml_music_style_transfer_tpu_torch.ops.kernels import _build
from ml_music_style_transfer_tpu_torch.train.loop import Trainer


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads per module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arrays(n=20, t=30, p=128, bins=64, seed=0):
    """Seeded rolls (n, t, p) and spectrograms stored (n, bins, t)."""
    rng = np.random.default_rng(seed)
    raw = {"pianoroll": rng.random((n, t, p), dtype=np.float32),
           "onoff": rng.random((n, t, p), dtype=np.float32)}
    for s in ("a", "b", "c"):
        raw[f"spec_{s}"] = rng.random((n, bins, t), dtype=np.float32)
    return raw


def _manual(ds, idx, cond_idx, style):
    return {"midi": ds.pianoroll[idx], "onoff": ds.onoff[idx],
            "target": np.stack([ds.specs[ds.styles[s]][i] for i, s in zip(idx, style)]),
            "cond": np.stack([ds.specs[ds.styles[s]][i] for i, s in zip(cond_idx, style)])}


def _copy(batch):
    return {k: np.array(v) for k, v in batch.items()}


class TestAgainstJax:
    def test_submissions_give_bit_equal_batches(self):
        ds = ChunkDataset.from_arrays(_arrays(), seed=1)
        port = fastloader.NativeBatchAssembler(ds, 5, n_slots=2, n_threads=2)
        jax_asm = jfastloader.NativeBatchAssembler(ds, 5, n_slots=2, n_threads=2)
        rng = np.random.default_rng(9)
        for _ in range(12):
            draws = (rng.integers(0, 20, 5), rng.integers(0, 20, 5), rng.integers(0, 3, 5))
            port.submit(*draws)
            jax_asm.submit(*draws)
            (ps, pb), (js, jb) = port.next(), jax_asm.next()
            want = _manual(ds, *draws)
            for k in ("midi", "onoff", "cond", "target", "weight"):
                np.testing.assert_array_equal(pb[k], jb[k])
                if k != "weight":
                    np.testing.assert_array_equal(pb[k], want[k])
            port.release(ps)
            jax_asm.release(js)
        port.close()
        jax_asm.close()

    @pytest.mark.parametrize("shuffle", [True, False])
    def test_epoch_plan_equals_jax(self, shuffle):
        """The same ds.rng state gives the same epochs, batch for batch, and
        leaves the same RNG state behind. The JAX assembler runs one worker
        thread: with two it hands out batches as they finish, the port's in
        submission order."""
        a = ChunkDataset.from_arrays(_arrays(n=23), seed=4)
        b = ChunkDataset.from_arrays(_arrays(n=23), seed=4)
        port = fastloader.NativeBatchAssembler(a, 4, n_threads=2)
        jax_asm = jfastloader.NativeBatchAssembler(b, 4, n_threads=1)
        for _ in range(2):
            got = [_copy(x) for x in port.epoch_batches(shuffle=shuffle)]
            want = [_copy(x) for x in jax_asm.epoch_batches(shuffle=shuffle)]
            assert len(got) == len(want) == 23 // 4
            for g, w in zip(got, want):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
        assert a.rng.integers(0, 2**31) == b.rng.integers(0, 2**31)
        port.close()
        jax_asm.close()


class TestAssembler:
    def test_batches_come_out_in_submission_order(self):
        """Four threads, rows of different sizes' worth of work: the order
        handed out is the order submitted, every time."""
        ds = ChunkDataset.from_arrays(_arrays(n=40, t=200, bins=512), seed=0)
        asm = fastloader.NativeBatchAssembler(ds, 8, n_slots=4, n_threads=4)
        rng = np.random.default_rng(3)
        plans = [(rng.integers(0, 40, 8), rng.integers(0, 40, 8), rng.integers(0, 3, 8))
                 for _ in range(60)]
        for k in range(0, 60, 3):
            for p in plans[k:k + 3]:
                asm.submit(*p)
            for p in plans[k:k + 3]:
                slot, batch = asm.next()
                np.testing.assert_array_equal(batch["target"], _manual(ds, *p)["target"])
                asm.release(slot)
        asm.close()

    def test_epoch_covers_the_data_and_survives_an_early_exit(self):
        ds = ChunkDataset.from_arrays(_arrays(n=12), seed=0)
        asm = ds.native_assembler(4)
        assert ds.native_assembler(4) is asm
        gen = asm.epoch_batches()
        next(gen)
        gen.close()  # returns the slot and drains what is in flight
        seen = [b["midi"][:, 0, 0].copy() for b in asm.epoch_batches(shuffle=True)]
        rows = {float(ds.pianoroll[i, 0, 0]): i for i in range(12)}
        assert sorted(rows[float(v)] for v in np.concatenate(seen)) == list(range(12))
        asm.close()

    def test_bounds_and_lengths_raise(self):
        ds = ChunkDataset.from_arrays(_arrays(), seed=0)
        asm = fastloader.NativeBatchAssembler(ds, 2, n_slots=2, n_threads=1)
        for bad in ((np.array([0, 99]), np.zeros(2), np.zeros(2)),
                    (np.array([0, 1]), np.array([0, -1]), np.zeros(2)),
                    (np.array([0, 1]), np.zeros(2), np.array([0, 7])),
                    (np.array([0, 1, 2]), np.zeros(3), np.zeros(3))):
            with pytest.raises(ValueError):
                asm.submit(*bad)
        asm.close()
        ds.pianoroll = ds.pianoroll.astype(np.float64)  # the library reads float32 rows
        with pytest.raises(ValueError, match="float32"):
            fastloader.NativeBatchAssembler(ds, 2)


class TestHostBuild:
    def test_built_by_the_host_route_apart_from_the_kernels(self):
        fastloader._lib()
        path = _build.host_library_path("fastloader")
        assert os.path.exists(path) and path.startswith(_build.BUILD_ROOT)
        assert os.path.dirname(path) != os.path.dirname(_build.library_path("dropout"))
        assert "fastloader.cpp" in _build._sources(".cpp")
        assert not any(f.endswith(".cpp") for f in _build._sources())  # nvcc never sees it

    def test_a_failed_build_raises(self, tmp_path, monkeypatch):
        src = tmp_path / "csrc"
        src.mkdir()
        (src / "broken.cpp").write_text("this is not C++\n")
        shutil.copy(os.path.join(_build.CSRC_DIR, "fastloader.cpp"), src)
        monkeypatch.setattr(_build, "CSRC_DIR", str(src))
        monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
        with pytest.raises(RuntimeError, match="broken.cpp"):
            _build.load_host("broken")
        assert _build.load_host("fastloader").fl_create is not None


class TestTrainerLoader:
    @pytest.mark.parametrize("native", [True, False])
    def test_train_epoch_feeds_its_loaders_batches(self, native, monkeypatch):
        """The Trainer's host-fed epoch hands each path's own batches to the
        step: the native plan (drawn up front) or the Python assembly."""
        raw = _arrays(n=9, t=860, p=128, bins=1025)
        ds = ChunkDataset.from_arrays(raw, seed=2)
        ref = ChunkDataset.from_arrays(raw, seed=2)
        tr = Trainer(ModelConfig(width_mult=1 / 16, compute_dtype="float32"),
                     TrainConfig(batch_size=4), device="cpu", use_native_loader=native)
        seen = []
        monkeypatch.setattr(tr, "train_step", lambda b, seed: seen.append(
            {k: v.numpy().copy() for k, v in b.items()}) or torch.zeros(()))
        tr.train_epoch(ds, 0)
        if native:
            asm = fastloader.NativeBatchAssembler(ref, 4)
            want = [_copy(b) for b in asm.epoch_batches(shuffle=True)]
            asm.close()
        else:
            want = list(ref.epoch_batches(4, shuffle=True, drop_last=True))
        assert len(seen) == len(want) == 2
        for g, w in zip(seen, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
