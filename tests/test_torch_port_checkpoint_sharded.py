"""The port's sharded asynchronous checkpoints (``train/checkpoint.py``'s
``.dcp`` path, ``Trainer.sharded_state_dict``/``load_sharded_state``) on the
CPU: the counterparts of tests/test_checkpoint_orbax.py:34-132 and
tests/test_zero_opt.py:145-248, plus the port against the JAX package's
orbax path and against its own ``.pt``.

The mesh runs are one spawn of 4 gloo ranks (``parallel/launch.spawn``; the
rank functions are in tests/torch_port_parallel_workers.py) at width 1/16,
float32, dropout off. Every comparison of restored state is bit for bit
(``np.array_equal``): a checkpoint moves bytes and computes nothing.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_port_parallel_workers as W
from ml_music_style_transfer_tpu.data import audio_io as jaudio
from ml_music_style_transfer_tpu.data import preprocess as jpp
from ml_music_style_transfer_tpu.midi import writer as jmidi_writer
from ml_music_style_transfer_tpu.testing import synthetic
from ml_music_style_transfer_tpu.train import checkpoint as jckpt
from ml_music_style_transfer_tpu_torch.compat import weights
from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.infer import AudioSynthesizer
from ml_music_style_transfer_tpu_torch.parallel import launch
from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
from ml_music_style_transfer_tpu_torch.train import cli as train_cli
from ml_music_style_transfer_tpu_torch.train.loop import Trainer, stage_batch

B, T = 4, 220  # 4 rows split over a (2, 2) and a (4, 1) mesh


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(b=B, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "midi": (rng.random((b, T, 128)) < 0.05).astype(np.float32),
        "onoff": rng.choice([-1, 0, 1], (b, T, 128), p=[0.02, 0.96, 0.02]).astype(np.float32),
        "cond": rng.random((b, T, 1025)).astype(np.float32),
        "target": rng.random((b, T, 1025)).astype(np.float32),
        "weight": np.ones((b,), np.float32),
    }


def _leaves(tree, path=()):
    """{path: leaf} of nested dicts, tuples and lists (empty ones have none)."""
    if isinstance(tree, (tuple, list)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (str(k),)))
        return out
    return {path: tree}


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), set(g) ^ set(w)
    for k, v in w.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        b = g[k].detach().cpu().numpy() if isinstance(g[k], torch.Tensor) else np.asarray(g[k])
        assert a.dtype == b.dtype or a.ndim == 0, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=".".join(k))


def _tree_bytes(tree) -> int:
    return sum(v.nbytes for v in _leaves(tree).values() if isinstance(v, np.ndarray))


@pytest.fixture(scope="module")
def tiny_h5(tmp_path_factory):
    """A synthetic preprocessed dataset (1 song, 2 styles) written by the
    JAX package, as tests/test_checkpoint_orbax.py's."""
    root = tmp_path_factory.mktemp("dcpdata")
    synthetic.make_dataset_dir(str(root / "raw"), song_ids=[9], styles=["cuba", "upright"],
                               duration=16.0, seed=6)
    for split in ("train", "test"):
        jpp.get_data(str(root / "raw"), str(root / "ds"), split, song_ids=[9],
                     styles=["cuba", "upright"])
    return str(root / "ds")


@pytest.fixture(scope="module")
def mesh_runs(tiny_h5, tmp_path_factory):
    return launch.spawn(W.sharded_checkpoints, 4,
                        (_batch(), str(tmp_path_factory.mktemp("dcp")), tiny_h5), device="cpu")


def _trainer(seed=0, steps=1, **kw):
    """A one-device CPU trainer after ``steps`` steps on ``_batch(2)``."""
    tr = Trainer(ModelConfig(**W.TINY_KW), TrainConfig(batch_size=2, **kw), device="cpu")
    tr.init_state(seed)
    batch = stage_batch(_batch(2), tr.device)
    for s in range(steps):
        tr.train_step(batch, s)
    return tr, batch


# ---- on a mesh --------------------------------------------------------------------

class TestShardedSaveRestoreOnAMesh:
    @pytest.mark.parametrize("mesh", ["same_mesh", "other_mesh"])
    def test_restore_into_sharded_buffers(self, mesh, mesh_runs):
        """Each rank of a fresh, differently seeded trainer restores its own
        slices: gathered whole, they are the state at the save call, though
        the saved trainer stepped in place while the write went on; on the
        (2, 2) ZeRO + TP mesh that wrote it and on a (4, 1) ZeRO mesh."""
        for r in mesh_runs:
            assert r[mesh]["epoch"] == 1
            _assert_trees_equal(r[mesh]["state"], r["want"])

    def test_save_gathers_nothing_and_writes_each_slice_once(self, mesh_runs):
        """Saving calls no all-gather (``comm.all_gather_cat`` is the port's
        only gather of weights and moments); each rank's file holds its
        slices, and the files together hold the whole state once (a
        replicated tensor is written by one rank) plus DCP's per-item
        framing, under 10 %."""
        for r in mesh_runs:
            assert r["save_gathers"] == []
        files = mesh_runs[0]["files"]
        data = {f: n for f, n in files.items() if f.endswith(".distcp")}
        assert len(data) == 4 and ".metadata" in files
        whole = _tree_bytes(mesh_runs[0]["want"])
        assert whole <= sum(data.values()) < 1.1 * whole, (data, whole)
        assert max(data.values()) < 0.5 * whole

    def test_zero_restore_then_step_is_bit_identical(self, mesh_runs):
        """tests/test_zero_opt.py:180-232: the step taken from the restored
        ZeRO + TP state equals the step the saved trainer took from the
        never-saved state, loss and weights bit for bit."""
        for r in mesh_runs:
            assert r["same_mesh"]["step_loss"] == r["flush_step_loss"]
            for k, v in r["next_params"].items():
                np.testing.assert_array_equal(r["same_mesh"]["next_params"][k], v, err_msg=k)

    def test_zero_fit_resume_end_to_end(self, mesh_runs):
        """tests/test_zero_opt.py:234-270: ``fit`` with ZeRO-1 + TP and
        ``"dcp"``, then resume: the resumed epoch starts from the
        checkpoint's optimizer state, each rank holding its slices of it,
        and trains to a finite loss; no uncommitted directory is left."""
        whole_moments = 2 * _tree_bytes(mesh_runs[0]["want"]["params"])
        for r in mesh_runs:
            fit = r["fit"]
            assert len(fit["loss_history"]) == 2 and np.all(np.isfinite(fit["loss_history"]))
            assert fit["latest"].endswith(".dcp")
            assert fit["moment_bytes"] < 0.4 * whole_moments  # ZeRO 1/2 of TP's 1/2
        assert mesh_runs[0]["fit"]["resumed_opt_equal"]
        assert not any(f.endswith(".tmp") for f in mesh_runs[0]["fit"]["listing"])


# ---- one device ---------------------------------------------------------------------

class TestShardedCheckpointOneDevice:
    def test_async_save_returns_staged_and_commits_by_rename(self, tmp_path):
        """The save returns before the write ends; steps taken meanwhile
        (in place, with the EMA) do not reach it; the directory appears
        under its name only once committed."""
        tr, batch = _trainer(ema_decay=0.9, warmup_steps=3)
        want = {k: v for k, v in W._tree_np(tr.state_dict(1)).items()}
        path = ckpt.save_checkpoint_sharded(str(tmp_path), 1, tr.sharded_state_dict(1))
        assert path == ckpt.sharded_checkpoint_path(str(tmp_path), 1)
        for s in range(2):
            tr.train_step(batch, 10 + s)
        ckpt.wait_for_async_saves()
        assert sorted(os.listdir(tmp_path)) == ["checkpoint-1.dcp"]
        _assert_trees_equal(ckpt.restore_checkpoint(path), want)
        t2, _ = _trainer(seed=1, steps=0, ema_decay=0.9, warmup_steps=3)
        assert t2.load_sharded_state(path) == 1
        _assert_trees_equal(t2.state_dict(1), want)

    def test_params_only_partial_restore(self, tmp_path):
        """Serving start-up reads one tree: ``params`` (or ``ema_params``)
        comes back whole, and the process reads under 1.5x the params'
        bytes (the rest: the checkpoint's metadata of every tree, each
        item's framing, modules imported on first use) from a directory
        three times their size (Adam's two moments). The JAX package's name
        for it reads the same. A missing ``ema_params`` raises the JAX
        message."""
        tr, _ = _trainer()
        path = ckpt.save_checkpoint_sharded(str(tmp_path), 2, tr.sharded_state_dict(2),
                                            wait=True)
        want = W._state_np(tr.model.state_dict())
        params_bytes = sum(v.nbytes for v in want.values())
        on_disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        assert on_disk > 2.9 * params_bytes

        def rchar():
            with open("/proc/self/io") as f:
                return int(next(line for line in f if line.startswith("rchar")).split()[1])

        r0 = rchar()
        got = ckpt.restore_checkpoint(path, keys=("params",))
        read = rchar() - r0
        assert read < 1.5 * params_bytes, (read, params_bytes)
        assert list(got) == ["params"]
        _assert_trees_equal(got["params"], want)
        _assert_trees_equal(ckpt.restore_params_sharded_host(path), want)
        with pytest.raises(ValueError, match="was --ema-decay set during training"):
            ckpt.restore_checkpoint(path, keys=("ema_params",))

    def test_staging_buffers_belong_to_the_caller(self, tmp_path, monkeypatch):
        """A caller's ``buffers`` are filled by the first save and reused by
        the next (the same storage; each restore is the state at its own
        save call). Without them the host copy lives only as long as its
        write: once joined, no staged tensor is left."""
        import gc
        import weakref

        tr, batch = _trainer()
        pool: dict = {}
        first = ckpt.save_checkpoint_sharded(str(tmp_path), 1, tr.sharded_state_dict(1),
                                             buffers=pool)
        ptrs = {k: v.data_ptr() for k, v in pool.items()}
        assert ptrs and all(isinstance(v, torch.Tensor) for v in pool.values())
        want1 = W._tree_np(tr.state_dict(1))
        tr.train_step(batch, 9)
        want2 = W._tree_np(tr.state_dict(2))
        second = ckpt.save_checkpoint_sharded(str(tmp_path), 2, tr.sharded_state_dict(2),
                                              buffers=pool, wait=True)
        assert {k: v.data_ptr() for k, v in pool.items()} == ptrs
        _assert_trees_equal(ckpt.restore_checkpoint(first), want1)
        _assert_trees_equal(ckpt.restore_checkpoint(second), want2)

        staged = []
        stage = ckpt._AsyncSaver.stage

        def spy(state, buffers):
            out = stage(state, buffers)
            staged.extend(weakref.ref(v) for v in _leaves(out).values()
                          if isinstance(v, torch.Tensor))
            return out

        monkeypatch.setattr(ckpt._AsyncSaver, "stage", staticmethod(spy))
        ckpt.save_checkpoint_sharded(str(tmp_path), 3, tr.sharded_state_dict(3))
        ckpt.wait_for_async_saves()
        gc.collect()
        assert staged and not [r for r in staged if r() is not None]

    def test_restore_refuses_other_optimizer_options(self, tmp_path):
        tr, _ = _trainer()
        path = ckpt.save_checkpoint_sharded(str(tmp_path), 1, tr.sharded_state_dict(1),
                                            wait=True)
        t2, _ = _trainer(steps=0, ema_decay=0.9)
        with pytest.raises(ValueError, match="other optimizer options"):
            t2.load_sharded_state(path)

    def test_dcp_restore_equals_pt_restore(self, tmp_path):
        """One state as ``.pt`` and as ``.dcp``: the two restores are equal,
        whole and key for key, and a resumed trainer holds the same."""
        tr, _ = _trainer(ema_decay=0.9)
        d = str(tmp_path)
        ckpt.save_checkpoint(d, 1, tr.state_dict(1))
        path = ckpt.save_checkpoint_sharded(d, 1, tr.sharded_state_dict(1), wait=True)
        pt = ckpt.restore_checkpoint(ckpt.checkpoint_path(d, 1))
        _assert_trees_equal(ckpt.restore_checkpoint(path), pt)
        t2, _ = _trainer(seed=1, steps=0, ema_decay=0.9)
        t2.load_sharded_state(path)
        _assert_trees_equal(t2.state_dict(1), pt)

    def test_orbax_and_dcp_restore_to_equal_jax_trees(self, tmp_path):
        """The same weights and optimizer state (warmup and EMA on) as a JAX
        orbax checkpoint (the JAX package's ``save_checkpoint_sharded``) and
        as a port ``.dcp``: the port's restore, translated by
        ``weights.to_jax_params``/``to_jax_opt_state``, is the orbax
        restore's tree, leaf for leaf."""
        cfg = TrainConfig(batch_size=2, ema_decay=0.9, warmup_steps=3)
        tr, _ = _trainer(ema_decay=0.9, warmup_steps=3)

        def to_jax(state):
            out = {"params": weights.to_jax_params(state["params"]),
                   "opt_state": weights.to_jax_opt_state(state["opt_state"], cfg),
                   "ema_params": weights.to_jax_params(state["ema_params"]),
                   "epoch": state["epoch"], "scheduler": state["scheduler"]}
            return ckpt.tree_map(
                lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, out)

        jpath = jckpt.save_checkpoint_sharded(str(tmp_path / "jax"), 1, to_jax(tr.state_dict(1)),
                                              wait=True)
        path = ckpt.save_checkpoint_sharded(str(tmp_path / "port"), 1, tr.sharded_state_dict(1),
                                            wait=True)
        _assert_trees_equal(to_jax(ckpt.restore_checkpoint(path)),
                            jckpt.restore_checkpoint_sharded_host(jpath))


class TestCheckpointResolution:
    def test_latest_and_best_see_dcp(self, tmp_path):
        d = str(tmp_path)
        os.makedirs(os.path.join(d, "checkpoint-3.dcp"))
        open(os.path.join(d, "checkpoint-2.pt"), "wb").close()
        assert ckpt.latest_checkpoint(d) == (os.path.join(d, "checkpoint-3.dcp"), 3)
        exp = ckpt.ExperimentState(1, 1, "x")
        exp.best_epoch = 3
        exp.save(d)
        assert ckpt.best_checkpoint(d) == (os.path.join(d, "checkpoint-3.dcp"), 3)
        # one epoch in several formats: .pt, then .msgpack, then .dcp
        open(os.path.join(d, "checkpoint-3.msgpack"), "wb").close()
        assert ckpt.latest_checkpoint(d)[0].endswith("checkpoint-3.msgpack")
        assert ckpt.best_checkpoint(d)[0].endswith("checkpoint-3.msgpack")
        open(os.path.join(d, "checkpoint-3.pt"), "wb").close()
        assert ckpt.latest_checkpoint(d)[0].endswith("checkpoint-3.pt")
        assert ckpt.best_checkpoint(d)[0].endswith("checkpoint-3.pt")

    def test_best_falls_back_when_a_save_never_committed(self, tmp_path):
        """hyperparams.json names an epoch whose write never committed (a
        ``.dcp.tmp`` left by a crash): resolution takes the newest committed
        checkpoint, and the temporary directory is no checkpoint."""
        d = str(tmp_path)
        exp = ckpt.ExperimentState(1, 1, "x")
        exp.best_epoch = 7
        exp.save(d)
        os.makedirs(os.path.join(d, "checkpoint-7.dcp.tmp"))
        open(os.path.join(d, "checkpoint-7.dcp.tmp", "__0_0.distcp"), "wb").close()
        os.makedirs(os.path.join(d, "checkpoint-5.dcp"))
        open(os.path.join(d, "checkpoint-3.msgpack"), "wb").close()
        assert ckpt.latest_checkpoint(d)[1] == 5
        path, epoch = ckpt.best_checkpoint(d)
        assert epoch == 5 and path.endswith("checkpoint-5.dcp")

    def test_a_save_replaces_an_uncommitted_and_a_committed_directory(self, tmp_path):
        tr, _ = _trainer()
        d = str(tmp_path)
        os.makedirs(os.path.join(d, "checkpoint-1.dcp.tmp"))
        open(os.path.join(d, "checkpoint-1.dcp.tmp", "stale"), "wb").close()
        for _ in range(2):
            path = ckpt.save_checkpoint_sharded(d, 1, tr.sharded_state_dict(1), wait=True)
        assert sorted(os.listdir(d)) == ["checkpoint-1.dcp"]
        assert "stale" not in os.listdir(path)
        _assert_trees_equal(ckpt.restore_checkpoint(path, keys=("params",))["params"],
                            W._state_np(tr.model.state_dict()))


class TestDcpFitResumeInfer:
    def test_fit_resume_and_infer_with_dcp(self, tiny_h5, tmp_path, monkeypatch):
        """tests/test_checkpoint_orbax.py:98-132 with ``--ckpt-format dcp``:
        the CLI trains an epoch into ``checkpoint-{best}.dcp``; ``fit``
        resumes from it; the synthesizer serves the best ``.dcp``'s params
        (read alone) and refuses ``use_ema`` on a run without an EMA."""
        monkeypatch.chdir(tmp_path)
        train_cli.main(["-data-dir", tiny_h5, "-exp-name", "dfit", "--batch-size", "2",
                        "--width-mult", str(1 / 16), "--ckpt-format", "dcp",
                        "--device", "cpu"])
        exp_dir = os.path.join("experiments", "dfit")
        with open(os.path.join(exp_dir, "hyperparams.json")) as f:
            best = json.load(f)["best_epoch"]
        assert os.path.isdir(os.path.join(exp_dir, f"checkpoint-{best}.dcp"))
        mcfg = ModelConfig(width_mult=1 / 16)
        tr = Trainer(mcfg, TrainConfig(epochs=2, test_freq=1, exp_name="dfit", batch_size=2),
                     device="cpu")
        _, exp = tr.fit(tiny_h5, resume=True, checkpoint_format="dcp")
        assert len(exp.loss_history) == 2 and np.all(np.isfinite(exp.loss_history))
        assert not any(f.endswith(".tmp") for f in os.listdir(exp_dir))

        rng = np.random.default_rng(5)
        notes = synthetic.random_song(rng, duration=6.0)
        jmidi_writer.save("u.mid", notes)
        jaudio.write_wav("u.wav", synthetic.render_notes(notes, "cuba", 44100, 6.0), 44100)
        synth = AudioSynthesizer(exp_dir, "u.mid", "u.wav", model_cfg=mcfg, device="cpu")
        path = ckpt.best_checkpoint(exp_dir)[0]
        assert path.endswith(".dcp")
        _assert_trees_equal(synth.model.state_dict(),
                            ckpt.restore_checkpoint(path, keys=("params",))["params"])
        y = synth.synthesize_waveform(n_iter=2)
        assert y.ndim == 1 and np.all(np.isfinite(y))
        with pytest.raises(ValueError, match="was --ema-decay set during training"):
            AudioSynthesizer(exp_dir, "u.mid", "u.wav", model_cfg=mcfg, device="cpu",
                             use_ema=True)


    def test_fit_frees_its_staging_buffers(self, tiny_h5, tmp_path, monkeypatch):
        """``fit`` hands every save of its run one buffer pool and empties it
        once the last write is joined: no page-locked copy of the state
        outlives the run."""
        pools = []
        save = ckpt.save_checkpoint_sharded

        def spy(*a, buffers=None, **kw):
            out = save(*a, buffers=buffers, **kw)
            pools.append((buffers, len(buffers)))
            return out

        monkeypatch.setattr(ckpt, "save_checkpoint_sharded", spy)
        monkeypatch.chdir(tmp_path)
        tr = Trainer(ModelConfig(width_mult=1 / 16),
                     TrainConfig(epochs=2, test_freq=1, exp_name="pool", batch_size=2),
                     device="cpu")
        tr.fit(tiny_h5, checkpoint_format="dcp")
        assert pools and all(n > 0 for _, n in pools)
        assert all(p is pools[0][0] for p, _ in pools) and pools[0][0] == {}


def test_pt_restore_of_some_keys_never_reads_the_others(tmp_path):
    """``restore_checkpoint(path, keys=...)`` on a ``.pt`` maps the file: the
    tensors not kept are never read. In a fresh process, serving's
    params-only read of a file holding 256 MB of moments beside 4 MB of
    params raises the peak resident memory by less than 64 MB."""
    path = str(tmp_path / "checkpoint-1.pt")
    ckpt.save_checkpoint(str(tmp_path), 1, {
        "params": {"w": torch.ones(1 << 20)},
        "opt_state": {"mu": {"w": torch.ones(1 << 25)}, "nu": {"w": torch.ones(1 << 25)}},
        "epoch": 1})
    code = textwrap.dedent(f"""
        import resource, torch
        from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
        torch.ones(8).sum()
        before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        state = ckpt.restore_checkpoint({path!r}, keys=("params",))
        assert list(state) == ["params"] and float(state["params"]["w"].sum()) == 1 << 20
        print((resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) * 1024)
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    grew = int(out.stdout.split()[-1])
    assert grew < 64 << 20, grew
