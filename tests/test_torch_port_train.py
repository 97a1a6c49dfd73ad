"""The port's training path against the JAX package on the CPU, at width
1/16 in float32 with T = 220: train-step parity with dropout off, eval
masking, overfitting with dropout on, remat, checkpoints, ``fit`` -> resume
-> serve, the device contract and the dropout wrapper against the JAX
kernel's interpreted contract. Inputs come from numpy seeds; tolerances are
stated per test."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.config import TrainConfig as JTrainConfig
from ml_music_style_transfer_tpu.data import audio_io as jaudio
from ml_music_style_transfer_tpu.data import preprocess as jpp
from ml_music_style_transfer_tpu.midi import writer as jmidi_writer
from ml_music_style_transfer_tpu.ops.pallas import dropout as jdropout
from ml_music_style_transfer_tpu.testing import synthetic
from ml_music_style_transfer_tpu.train import checkpoint as jckpt
from ml_music_style_transfer_tpu.train.loop import Trainer as JTrainer
from ml_music_style_transfer_tpu_torch.compat import from_jax_params, weights
from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
from ml_music_style_transfer_tpu_torch.infer import AudioSynthesizer
from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as dk
from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
from ml_music_style_transfer_tpu_torch.train import cli as train_cli
from ml_music_style_transfer_tpu_torch.train.loop import Trainer

TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32")
T = 220  # encoder 220 -> 13, decoder back to 220
STEPS = 5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Tier-1 runs six test workers on one machine; torch's default of one
    thread per core oversubscribes it (a train step here ran 10x slower),
    so this module's torch ops use two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "midi": (rng.random((b, T, 128)) < 0.05).astype(np.float32),
        "onoff": rng.choice([-1.0, 0.0, 1.0], (b, T, 128), p=[0.02, 0.96, 0.02]).astype(np.float32),
        "cond": (rng.random((b, T, 1025)) * 3).astype(np.float32),
        "target": (rng.random((b, T, 1025)) * 3).astype(np.float32),
        "weight": np.ones(b, np.float32),
    }


def _torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype if k != "weight" else torch.float32)
            for k, v in batch.items()}


def _trainer(spectral=0.0, dropout_rate=0.0, compute_dtype="float32", **cfg_kw):
    mcfg = ModelConfig(width_mult=1 / 16, compute_dtype=compute_dtype, dropout_rate=dropout_rate,
                       **cfg_kw)
    return Trainer(mcfg, TrainConfig(batch_size=2, spectral_loss_weight=spectral), device="cpu")


@pytest.fixture(scope="module")
def jax_init():
    """A seeded flax init of the dropout-free tiny model, as numpy."""
    tr = JTrainer(JModelConfig(dropout_rate=0.0, **TINY_KW), JTrainConfig(batch_size=2),
                  use_native_loader=False)
    params, _ = tr.init_state(0)
    return jax.tree_util.tree_map(np.asarray, params)


def _run_jax(init, batches, spectral=0.0):
    tr = JTrainer(JModelConfig(dropout_rate=0.0, **TINY_KW),
                  JTrainConfig(batch_size=2, spectral_loss_weight=spectral),
                  use_native_loader=False)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = jax.jit(tr.tx.init)(params)
    losses = []
    for b in batches:
        params, opt_state, loss = tr.train_step(
            params, opt_state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        losses.append(float(loss))
    return np.asarray(losses), from_jax_params(jax.device_get(params))


def _run_port(init, batches, spectral=0.0, float64=False):
    tr = _trainer(spectral, compute_dtype="float64" if float64 else "float32")
    tr.init_state(0)
    tr.model.load_state_dict(from_jax_params(init))
    if float64:
        tr.model.double()  # in place: the optimizer keeps the same parameters
    dt = torch.float64 if float64 else torch.float32
    losses = [float(tr.train_step(_torch(b, dt), 0)) for b in batches]
    return np.asarray(losses), {k: v.double() for k, v in tr.model.state_dict().items()}


def _max_dev(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def _l2_dev(a, b):
    return sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in a) ** 0.5


class TestTrainStepParity:
    """Identical init and batches through the JAX ``Trainer.train_step`` and
    the port's, dropout off on both sides (compat/train_parity.py:38-41).
    Adam's first steps are about lr * sign(grad), so two float32
    realisations of one run drift apart wherever a gradient sits at rounding
    level. The yardstick is therefore the port's own float32-vs-float64
    divergence on the same run: the port must stay within twice it of JAX
    (or within 1e-4 relative on the losses and 1e-3 of the weights' scale on
    the params, where the yardstick is smaller than float32 noise)."""

    def test_loss_trajectory_and_params_match_jax(self, jax_init):
        batches = [_batch(seed=s) for s in range(STEPS)]
        lj, pj = _run_jax(jax_init, batches)
        lt, pt = _run_port(jax_init, batches)
        l64, p64 = _run_port(jax_init, batches, float64=True)
        assert abs(lt[0] - lj[0]) / lj[0] < 1e-5  # pure forward + L1: no optimizer yet
        traj, null = np.max(np.abs(lt - lj) / lj), np.max(np.abs(l64 - lt) / lt)
        assert traj <= max(2 * null, 1e-4), (traj, null, lj, lt)
        scale = max(float(v.abs().max()) for v in pt.values())
        dev, null_p = _max_dev(pt, pj), _max_dev(p64, pt)
        assert dev <= max(2 * null_p, 1e-3 * scale), (dev, null_p, scale)
        assert _l2_dev(pt, pj) <= 2 * _l2_dev(p64, pt)
        init = from_jax_params(jax_init)
        assert _max_dev(pt, {k: v.double() for k, v in init.items()}) > 1e-4  # Adam moved them
        assert lt[-1] < lt[0]

    def test_first_gradient_is_as_close_to_float64_as_jax(self, jax_init):
        """No Adam in the way: the port's float32 gradient of the step-0 L1
        loss, measured against the port's float64 gradient, must be within
        twice the JAX package's float32 error on the same measure (global
        L2). L1's gradient is sign(pred - target), so elements where pred and
        target agree to rounding flip sign between any two float32 runs (on
        this batch the port sits 4e-3 and JAX 2e-2 from float64, relative
        L2; the port's float64 run shares its own summation order)."""
        from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
        from ml_music_style_transfer_tpu.train import losses as jlosses

        b = _batch(seed=0)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jmodel = JPerformanceNet(JModelConfig(dropout_rate=0.0, **TINY_KW))
        gj = from_jax_params(jax.device_get(jax.jit(jax.grad(lambda p: jlosses.l1_loss(
            jmodel.apply(p, jb["midi"], jb["cond"], jb["onoff"]), jb["target"], jb["weight"])))(
                jax.tree_util.tree_map(jnp.asarray, jax_init))))
        grads = {}
        for dt in ("float32", "float64"):
            tr = _trainer(compute_dtype=dt)
            tr.init_state(0)
            tr.model.load_state_dict(from_jax_params(jax_init))
            tr.model.to(getattr(torch, dt))
            tr.loss(_torch(b, getattr(torch, dt)), 0).backward()
            grads[dt] = {k: p.grad.double() for k, p in tr.model.named_parameters()}
        g64 = grads["float64"]
        port, jax_err = _l2_dev(grads["float32"], g64), _l2_dev(gj, g64)
        norm = _l2_dev(g64, {k: torch.zeros_like(v) for k, v in g64.items()})
        assert port <= 2 * jax_err and port < 0.05 * norm, (port, jax_err, norm)

    def test_one_step_with_spectral_loss_matches_jax(self, jax_init):
        batches = [_batch(seed=9)]
        lj, pj = _run_jax(jax_init, batches, spectral=0.1)
        lt, pt = _run_port(jax_init, batches, spectral=0.1)
        _, p64 = _run_port(jax_init, batches, spectral=0.1, float64=True)
        assert abs(lt[0] - lj[0]) / lj[0] < 1e-5
        scale = max(float(v.abs().max()) for v in pt.values())
        assert _max_dev(pt, pj) <= max(2 * _max_dev(p64, pt), 1e-3 * scale)
        assert all(bool(torch.isfinite(v).all()) for v in pt.values())


class TestTrainer:
    def test_eval_step_masks_padded_items(self):
        """As tests/test_train.py: a batch padded with zero-weight items
        gives the unpadded batch's MSE (1e-5 absolute)."""
        tr = _trainer()
        tr.init_state(0)
        b2 = _torch(_batch())
        b4 = {k: torch.cat([v, torch.zeros_like(v)]) for k, v in b2.items()}
        b4["weight"] = torch.tensor([1.0, 1.0, 0.0, 0.0])
        assert abs(float(tr.eval_step(b2)) - float(tr.eval_step(b4))) < 1e-5

    def test_overfits_one_batch_with_dropout_on(self):
        """As tests/test_train.py: below 0.7x the first loss within 25
        steps, through the dropout path (plain Philox on the CPU)."""
        tr = _trainer(dropout_rate=0.2)
        tr.init_state(0)
        batch = _torch(_batch())
        losses = [float(tr.train_step(batch, tr.next_dropout_seed())) for _ in range(25)]
        assert losses[-1] < 0.7 * losses[0], losses
        assert losses[-1] < losses[len(losses) // 2]

    def test_dropout_seeds_are_64_bit_and_reproducible(self):
        a, b = _trainer(), _trainer()
        seeds = [a.next_dropout_seed() for _ in range(8)]
        assert seeds == [b.next_dropout_seed() for _ in range(8)]
        assert all(0 <= s < 2**64 for s in seeds) and max(seeds) >= 2**32

    def test_remat_gives_the_same_loss_and_gradients(self):
        """Recomputing the encoder DownConvs changes memory, not values
        (1e-6 relative), and it does keep fewer tensors for the backward."""
        grads, saved = {}, {}
        for remat in (False, True):
            tr = _trainer(dropout_rate=0.2, remat=remat)
            tr.init_state(0)
            n_saved = [0]

            def pack(t, n=n_saved):
                n[0] += t.numel()
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = tr.loss(_torch(_batch()), 42)
            loss.backward()
            grads[remat] = (float(loss.detach()), {k: p.grad.clone() for k, p in tr.model.named_parameters()})
            saved[remat] = n_saved[0]
        assert grads[True][0] == pytest.approx(grads[False][0], rel=1e-6)
        for k, g in grads[False][1].items():
            torch.testing.assert_close(grads[True][1][k], g, rtol=1e-6, atol=1e-9 + 1e-6 * float(g.abs().max()))
        assert saved[True] < saved[False]

    @pytest.mark.parametrize("option", [dict(zero_opt=True), dict(mesh_shape=(2, 1))])
    def test_options_not_ported_raise_naming_the_roadmap(self, option):
        """ROADMAP item 9 has landed. With no mesh ``zero_opt`` changes
        nothing (one device: the JAX Trainer's 1-wide data axis); a mesh
        the launch has no ranks for raises (the multi-rank paths are in
        test_torch_port_parallel.py)."""
        from ml_music_style_transfer_tpu_torch.train import optim

        if "mesh_shape" in option:
            with pytest.raises(ValueError, match="needs 2 ranks, the launch has 1"):
                Trainer(ModelConfig(**TINY_KW), TrainConfig(**option), device="cpu")
            return
        tr = Trainer(ModelConfig(**TINY_KW), TrainConfig(**option), device="cpu")
        tr.init_state(0)
        assert tr.mesh is None and isinstance(tr.optimizer, torch.optim.Adam)
        assert not isinstance(tr.optimizer, optim.ZeroOptimizer)

    def test_default_device_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(ModelConfig(**TINY_KW), TrainConfig())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["-data-dir", "unused"])

    def test_port_imports_without_h5py(self):
        code = ("import sys; sys.modules['h5py'] = None\n"
                "import ml_music_style_transfer_tpu_torch.train.cli\n"
                "import ml_music_style_transfer_tpu_torch.infer.cli\n"
                "from ml_music_style_transfer_tpu_torch.data import dataset, hdf5_store\n"
                "import numpy as np\n"
                "raw = {'pianoroll': np.zeros((3, 860, 128)), 'onoff': np.zeros((3, 860, 128)),\n"
                "       'spec_a': np.zeros((3, 1025, 860))}\n"
                "assert dataset.ChunkDataset.from_arrays(raw).n_data == 3\n"
                "try:\n"
                "    hdf5_store.load_dataset('x.hdf5')\n"
                "except ImportError:\n"
                "    print('h5py only when reading')\n")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "h5py only when reading" in out.stdout


class TestCheckpoint:
    def test_restore_continues_bit_identically(self, tmp_path):
        d = str(tmp_path)
        batches = [_torch(_batch(seed=s)) for s in (1, 2)]
        a = _trainer(dropout_rate=0.2)
        a.init_state(0)
        a.train_step(batches[0], 11)
        a.set_lr(5e-4)
        a.scheduler.step(0.5)
        path = ckpt.save_checkpoint(d, 1, a.state_dict(1))
        exp = ckpt.ExperimentState(3, 1, "x")
        exp.best_epoch = 1
        exp.save(d)
        assert ckpt.latest_checkpoint(d) == (path, 1) == ckpt.best_checkpoint(d)
        state = ckpt.restore_checkpoint(path)
        assert state["epoch"] == 1 and set(state) == {"params", "opt_state", "epoch", "scheduler"}

        b = _trainer(dropout_rate=0.2)
        b.init_state(seed=123)  # another init: everything must come from the file
        b.load_state(state)
        assert b.optimizer.param_groups[0]["lr"] == 5e-4 and b.scheduler == a.scheduler
        la, lb = a.train_step(batches[1], 12), b.train_step(batches[1], 12)
        assert torch.equal(la, lb)
        for (k, pa), pb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            assert torch.equal(pa, pb), k

    def test_hyperparams_json_has_the_jax_fields(self, tmp_path):
        ckpt.ExperimentState(2, 1, "e").save(str(tmp_path))
        with open(tmp_path / "hyperparams.json") as f:
            ours = json.load(f)
        assert set(ours) == set(jckpt.ExperimentState(2, 1, "e").__dict__)
        back = jckpt.ExperimentState.load(str(tmp_path))  # the JAX package reads it
        assert back.train_epoch == 2 and back.best_epoch == 0

    def test_resolution_order(self, tmp_path):
        d = str(tmp_path)
        exp = ckpt.ExperimentState(5, 1, "x")
        exp.best_epoch = 2
        exp.save(d)
        for e in (1, 3):
            ckpt.save_checkpoint(d, e, {"epoch": e})
        assert ckpt.latest_checkpoint(d)[1] == 3
        assert ckpt.best_checkpoint(d) == (ckpt.checkpoint_path(d, 3), 3)  # best lost: newest
        open(os.path.join(d, "checkpoint-2.tar"), "wb").close()
        assert ckpt.best_checkpoint(d)[0].endswith("checkpoint-2.tar")
        ckpt.save_checkpoint(d, 2, {"epoch": 2})
        assert ckpt.best_checkpoint(d)[0].endswith("checkpoint-2.pt")

    def test_jax_formats_only_raise(self, tmp_path):
        """A JAX msgpack resolves and reads (item 7); so does a directory
        holding only orbax checkpoints (item 7a; it used to raise): the
        JAX package's answers, read as it restores them."""
        d = str(tmp_path)
        path = jckpt.save_checkpoint(d, 3, {"epoch": 3})
        exp = jckpt.ExperimentState(5, 1, "x")
        exp.best_epoch = 3
        exp.save(d)
        assert ckpt.latest_checkpoint(d) == (path, 3) == ckpt.best_checkpoint(d)
        assert ckpt.restore_checkpoint(path) == {"epoch": 3}
        o = str(tmp_path / "orbax")
        opath = jckpt.save_checkpoint_sharded(o, 2, {"epoch": 2, "scheduler": {"lr": 0.5}},
                                              wait=True)
        exp.best_epoch = 2
        exp.save(o)
        for fn in ("latest_checkpoint", "best_checkpoint"):
            assert getattr(ckpt, fn)(o) == getattr(jckpt, fn)(o) == (opath, 2)
        assert ckpt.restore_checkpoint(opath) == jckpt.restore_checkpoint_sharded_host(opath) \
            == {"epoch": 2, "scheduler": {"lr": 0.5}}
        assert ckpt.latest_checkpoint(str(tmp_path / "empty")) is None


def _assert_jax_restores(path, want):
    """The JAX package's host restore of an orbax directory is ``want``
    (numpy leaves), leaf for leaf, both in flax's state-dict layout (optax's
    sequences keyed "0", "1", ...; its ``EmptyState`` as ``{}``)."""
    got = weights.flax_state_dict(jckpt.restore_checkpoint_sharded_host(path))
    want = weights.flax_state_dict(want)

    def eq(a, b, where):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), where
            for k in b:
                eq(a[k], b[k], f"{where}/{k}")
        elif isinstance(b, np.ndarray):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), where
        else:
            assert type(a) is type(b) and a == b, where

    eq(got, want, "")


@pytest.fixture(scope="module")
def tiny_h5(tmp_path_factory):
    """Synthetic preprocessed dataset written by the JAX package: 1 song,
    2 styles, a few chunks (as tests/test_train.py)."""
    root = tmp_path_factory.mktemp("traindata")
    synthetic.make_dataset_dir(str(root / "raw"), song_ids=[7], styles=["cuba", "upright"],
                               duration=16.0, seed=5)
    for split in ("train", "test"):
        jpp.get_data(str(root / "raw"), str(root / "ds"), split, song_ids=[7],
                     styles=["cuba", "upright"])
    return str(root / "ds")


class TestFit:
    def test_fit_resume_then_serve(self, tiny_h5, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        mcfg = ModelConfig(**TINY_KW)
        _, exp = Trainer(mcfg, TrainConfig(epochs=2, exp_name="t1", batch_size=2),
                         device="cpu").fit(tiny_h5)
        exp_dir = os.path.join("experiments", "t1")
        with open(os.path.join(exp_dir, "hyperparams.json")) as f:
            hp = json.load(f)
        assert set(hp) == set(jckpt.ExperimentState(2, 1, "t1").__dict__)
        assert hp["best_epoch"] >= 1 and len(hp["loss_history"]) == hp["best_epoch"]
        assert os.path.exists(os.path.join(exp_dir, f"checkpoint-{hp['best_epoch']}.pt"))
        with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
            events = [json.loads(line)["event"] for line in f]
        assert events.count("train_epoch") == 2 and events.count("eval") == 2

        tr = Trainer(mcfg, TrainConfig(epochs=3, exp_name="t1", batch_size=2), device="cpu")
        _, exp = tr.fit(tiny_h5, resume=True)
        assert len(exp.loss_history) == 3 and np.all(np.isfinite(exp.loss_history))

        rng = np.random.default_rng(3)
        notes = synthetic.random_song(rng, duration=6.0)
        midi, wav = str(tmp_path / "u.mid"), str(tmp_path / "u.wav")
        jmidi_writer.save(midi, notes)
        jaudio.write_wav(wav, synthetic.render_notes(notes, "harpsichord", 44100, 4.0), 44100)
        synth = AudioSynthesizer(exp_dir, midi, wav, model_cfg=mcfg, device="cpu")
        best = ckpt.restore_checkpoint(ckpt.best_checkpoint(exp_dir)[0])["params"]
        for k, v in synth.model.state_dict().items():  # MBR weights too: served as trained
            assert torch.equal(v, best[k]), k
        y = synth.synthesize_waveform(n_iter=2)
        assert y.ndim == 1 and len(y) > 44100 and np.all(np.isfinite(y))

    def test_fit_resume_refuses_a_newer_orbax_checkpoint(self, tiny_h5, tmp_path, monkeypatch,
                                                         capsys):
        """A run directory holding checkpoint-3.msgpack and a newer
        checkpoint-5.orbax of a JAX Trainer's state (optax's tuples): the
        JAX package's resume takes the orbax one (its
        ``latest_checkpoint``), and so does the port's (it used to raise),
        with that state's weights, and trains the next epoch."""
        monkeypatch.chdir(tmp_path)
        d = os.path.join("experiments", "mixed")
        os.makedirs(d)
        jckpt.save_checkpoint(d, 3, {"epoch": 3})
        jtr = JTrainer(JModelConfig(**TINY_KW), JTrainConfig(batch_size=2),
                       use_native_loader=False)
        src = Trainer(ModelConfig(**TINY_KW), TrainConfig(batch_size=2), device="cpu")
        src.init_state(4)
        params = {"params": jax.tree_util.tree_map(
            np.asarray, src.jax_state_dict(5)["params"]["params"])}
        jckpt.save_checkpoint_sharded(d, 5, {
            "params": params, "opt_state": jax.jit(jtr.tx.init)(params), "epoch": 5,
            "scheduler": jtr.scheduler.state_dict()}, wait=True)
        exp = jckpt.ExperimentState(6, 1, "mixed")
        exp.best_epoch = 5
        exp.save(d)
        assert jckpt.latest_checkpoint(d) == (os.path.join(d, "checkpoint-5.orbax"), 5)
        tr = Trainer(ModelConfig(**TINY_KW), TrainConfig(epochs=6, exp_name="mixed",
                                                         batch_size=2), device="cpu")
        orig = tr.load_state
        loaded = []
        tr.load_state = lambda state: (loaded.append(state["epoch"]), orig(state))
        _, exp = tr.fit(tiny_h5, resume=True)
        assert loaded == [5] and "resumed from" in capsys.readouterr().out
        assert len(exp.loss_history) == 1 and np.isfinite(exp.loss_history[0])

    def test_fit_refuses_what_is_not_ported(self, tiny_h5, tmp_path, monkeypatch):
        """The device-resident path (item 6) has landed: ``fit`` and the
        four resident methods run on a file without audio as far as that
        allows (the store names --store-audio); orbax (item 7a) still
        raises. The mesh and ZeRO (item 9) have landed: a mesh the launch
        has no ranks for raises ValueError, and so does an unknown store
        placement. --debug-nans (item 10) has landed: the CLI trains under
        NaN debugging with no false positive. Orbax (item 7a) has landed
        too: ``checkpoint_format="orbax"`` and ``--ckpt-format orbax`` (both
        used to raise) write directories the JAX package restores."""
        tr = Trainer(ModelConfig(**TINY_KW), TrainConfig(batch_size=2), exp_root=str(tmp_path),
                     device="cpu")
        with pytest.raises(ValueError, match="store-audio"):
            tr.fit(tiny_h5, device_resident=True)
        from ml_music_style_transfer_tpu_torch.data.device_store import DeviceDataStore
        from ml_music_style_transfer_tpu_torch.data.hdf5_store import load_dataset

        raw = load_dataset(tiny_h5 + "_train.hdf5")
        raw = {k: v for k, v in raw.items() if not k.startswith("spec_")}
        raw["audio_cuba"] = np.random.default_rng(0).standard_normal(
            (raw["pianoroll"].shape[0], 219904)).astype(np.float32) * 0.05
        store = DeviceDataStore.from_arrays(raw, device="cpu")
        tr.init_state(0)
        args = (store.audio, store.pianoroll, store.onoff) + next(store.draw_epoch_indices(2))
        assert np.isfinite(float(tr.train_step_resident(*args, 1)))
        assert np.isfinite(float(tr.eval_step_resident(*args)))
        assert np.isfinite(tr.train_epoch_resident(store, 0))
        assert np.isfinite(tr.evaluate_resident(store))
        with pytest.raises(ValueError, match="unknown store_sharding"):
            tr.fit(tiny_h5, store_sharding="rows")
        otr = Trainer(ModelConfig(**TINY_KW), TrainConfig(batch_size=2, exp_name="o"),
                      exp_root=str(tmp_path), device="cpu")
        otr.fit(tiny_h5, checkpoint_format="orbax")
        opath = ckpt.checkpoint_path(os.path.join(str(tmp_path), "o"), 1, "orbax")
        _assert_jax_restores(opath, ckpt.tree_map(
            lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, otr.jax_state_dict(1)))
        for flags, err, msg in (
                (["--mesh-data", "2"], ValueError, "needs 2 ranks, the launch has 1"),
                (["--mesh-model", "2", "--zero-opt"], ValueError, "needs 2 ranks")):
            with pytest.raises(err, match=msg):
                train_cli.main(["-data-dir", tiny_h5, "--device", "cpu", "-exp-name", "r"]
                               + flags)
        monkeypatch.chdir(tmp_path)
        train_cli.main(["-data-dir", tiny_h5, "--device", "cpu", "-exp-name", "co",
                        "--batch-size", "2", "--width-mult", str(1 / 16),
                        "--ckpt-format", "orbax"])
        cdir = str(tmp_path / "experiments" / "co")
        cpath, _ = ckpt.best_checkpoint(cdir)
        assert cpath.endswith("checkpoint-1.orbax") and jckpt.best_checkpoint(cdir)[0] == cpath
        _assert_jax_restores(cpath, ckpt.tree_map(
            lambda v: v.numpy() if isinstance(v, torch.Tensor) else v,
            ckpt.restore_checkpoint(cpath)))
        train_cli.main(["-data-dir", tiny_h5, "--device", "cpu", "-exp-name", "d",
                        "--batch-size", "2", "--width-mult", str(1 / 16), "--debug-nans"])
        assert ckpt.latest_checkpoint(str(tmp_path / "experiments" / "d")) is not None
        assert not torch.is_anomaly_enabled()

    def test_cli_trains_with_stream_bf16(self, tiny_h5, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        train_cli.main(["-data-dir", tiny_h5, "-exp-name", "c", "--batch-size", "2",
                        "--width-mult", str(1 / 16), "--stream-bf16", "--device", "cpu"])
        assert ckpt.latest_checkpoint(os.path.join("experiments", "c")) is not None

    def test_chunk_dataset_from_arrays_matches_the_hdf5_path(self, tiny_h5):
        from ml_music_style_transfer_tpu_torch.data.hdf5_store import load_dataset

        a = ChunkDataset(tiny_h5 + "_train.hdf5", seed=3)
        b = ChunkDataset.from_arrays(load_dataset(tiny_h5 + "_train.hdf5", include_audio=False),
                                     seed=3)
        for ba, bb in zip(a.epoch_batches(2, drop_last=False), b.epoch_batches(2, drop_last=False)):
            for k in ba:
                np.testing.assert_array_equal(ba[k], bb[k])


class TestDropoutContract:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rate", [0.2, 0.3])
    def test_mask_contract_matches_the_jax_kernel(self, dtype, rate):
        """The JAX kernel's interpreter stubs its random bits to zero, so it
        keeps every element: shape, dtype and the exact scale value are what
        can be compared (tests/test_pallas_kernels.py:50-64)."""
        want = np.asarray(jdropout.dropout_mask(jnp.int32(7), (4, 100, 24), rate,
                                                dtype=jnp.dtype(dtype), interpret=True))
        got = dk.dropout_mask(7, 0, (4, 100, 24), rate, getattr(torch, dtype), device="cpu")
        assert tuple(got.shape) == want.shape and str(got.dtype) == f"torch.{dtype}"
        scale = float(np.asarray(want.astype(np.float32)).max())
        assert np.all(np.asarray(want.astype(np.float32)) == scale)
        assert set(got.float().unique().tolist()) == {0.0, scale}
        assert dk.keep_threshold(rate) == jdropout._keep_threshold(rate)
