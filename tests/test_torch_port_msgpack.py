"""The port's flax-msgpack reader and writer (``train/flax_msgpack.py``),
its translation of the JAX ``Trainer``'s checkpoints (``compat/weights.py``,
``Trainer.load_state`` / ``jax_state_dict``) and serving from them, against
the JAX package on the CPU at width 1/16, float32, T = 220.

Every checkpoint layout comes from files the JAX package writes: the JAX
``Trainer``'s transform for each set of options, stepped on seeded random
gradients, saved by its ``save_checkpoint`` (the writer its ``fit`` uses),
and one ``fit`` of the JAX ``Trainer`` with ``ema_decay``. Continuations
feed both sides the same gradients, so the parameters agree to the two
optimizers' float32 rounding: within 2e-8 plus 2 % of one step's size
(lr = 1e-3) per element."""
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.config import TrainConfig as JTrainConfig
from ml_music_style_transfer_tpu.data import audio_io as jaudio
from ml_music_style_transfer_tpu.data import preprocess as jpp
from ml_music_style_transfer_tpu.infer import AudioSynthesizer as JSynth
from ml_music_style_transfer_tpu.midi import writer as jmidi_writer
from ml_music_style_transfer_tpu.testing import synthetic
from ml_music_style_transfer_tpu.train import checkpoint as jckpt
from ml_music_style_transfer_tpu.train.loop import Trainer as JTrainer
from ml_music_style_transfer_tpu.train.optim import get_param_ema as jget_param_ema
from ml_music_style_transfer_tpu_torch.compat import (from_jax_opt_state, from_jax_params,
                                                      to_jax_opt_state, to_jax_params)
from ml_music_style_transfer_tpu_torch.compat.weights import flax_state_dict
from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.infer import AudioSynthesizer
from ml_music_style_transfer_tpu_torch.scripts import serve
from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
from ml_music_style_transfer_tpu_torch.train import cli as train_cli
from ml_music_style_transfer_tpu_torch.train import flax_msgpack, optim
from ml_music_style_transfer_tpu_torch.train.loop import Trainer

LR = 1e-3
TINY = dict(width_mult=1 / 16, compute_dtype="float32", dropout_rate=0.0)
ALL = dict(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16", grads_dtype="bfloat16",
           grad_clip_norm=1.0, warmup_steps=3, ema_decay=0.9, grad_accum=2)
LAYOUTS = {
    "default": {},
    "mu_bf16": dict(adam_mu_dtype="bfloat16"),
    "compact": dict(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16"),
    "clip": dict(grad_clip_norm=1.0),
    "warmup_ema": dict(warmup_steps=3, ema_decay=0.9),
    "accum": dict(grad_accum=2),
    "all": ALL,
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Tier-1 runs six test workers on one machine: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    tr = JTrainer(JModelConfig(**TINY), JTrainConfig(batch_size=2), use_native_loader=False)
    params, _ = tr.init_state(0)
    return jax.tree_util.tree_map(np.asarray, params)


def _grads(init, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32), init)


class _JaxRun:
    """The JAX Trainer's transform for ``opts``, stepped on given
    gradients as its train_step does (loop.py:155-167)."""

    def __init__(self, init, opts):
        self.cfg = JTrainConfig(batch_size=2, learning_rate=LR, **opts)
        self.tr = JTrainer(JModelConfig(**TINY), self.cfg, use_native_loader=False)
        self.params = jax.tree_util.tree_map(jnp.asarray, init)
        self.opt_state = jax.jit(self.tr.tx.init)(self.params)
        self.update = jax.jit(self.tr.tx.update)

    def step(self, grads):
        g = jax.tree_util.tree_map(jnp.asarray, grads)
        if self.cfg.grads_dtype is not None:
            g = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16).astype(jnp.float32), g)
        u, self.opt_state = self.update(g, self.opt_state, self.params)
        self.params = optax.apply_updates(self.params, u)

    def state(self, epoch=1):
        s = {"params": self.params, "opt_state": self.opt_state, "epoch": epoch,
             "scheduler": self.tr.scheduler.state_dict()}
        if self.cfg.ema_decay is not None:
            s["ema_params"] = jget_param_ema(self.opt_state)
        return s


def _port_trainer(opts, seed=0):
    tr = Trainer(ModelConfig(**TINY), TrainConfig(batch_size=2, learning_rate=LR, **opts),
                 device="cpu")
    tr.init_state(seed)
    return tr


def _port_step(tr, grads):
    g = from_jax_params(grads)
    tr.optimizer.zero_grad()
    for name, p in tr.model.named_parameters():
        p.grad = g[name].clone()
    tr.optimizer.step()


def _assert_close_params(tr, jax_params, steps):
    want = from_jax_params(jax.device_get(jax_params))
    for k, v in tr.model.state_dict().items():
        err = (v.double() - want[k].double()).abs().max().item()
        assert err <= 2e-8 + 0.02 * LR * steps, (k, err)


def _assert_tree_equal(ours, flax_tree, path=""):
    """``ours`` (the port reader's tree) holds what flax's reader gives."""
    if isinstance(flax_tree, dict):
        assert isinstance(ours, dict) and set(ours) == set(flax_tree), path
        for k in flax_tree:
            _assert_tree_equal(ours[k], flax_tree[k], f"{path}/{k}")
    elif isinstance(flax_tree, np.ndarray):
        assert isinstance(ours, torch.Tensor) and tuple(ours.shape) == flax_tree.shape, path
        if flax_tree.dtype.name == "bfloat16":
            assert ours.dtype == torch.bfloat16, path
            assert np.array_equal(ours.view(torch.int16).numpy(), flax_tree.view(np.int16)), path
        else:
            assert str(ours.dtype) == f"torch.{flax_tree.dtype.name}", path
            assert np.array_equal(ours.numpy(), flax_tree), path
    else:
        assert ours == flax_tree and type(ours) is type(flax_tree), path


def _jax_file(tmp_path, init, opts, n_calls=3):
    run = _JaxRun(init, opts)
    for s in range(n_calls):
        run.step(_grads(init, s))
    return run, jckpt.save_checkpoint(str(tmp_path), 1, run.state())


class TestReader:
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_reads_what_flax_reads(self, tmp_path, jax_init, layout):
        """Each layout of the JAX Trainer's checkpoint: the same tree as
        flax.serialization.msgpack_restore, leaf for leaf and bit for bit
        (bf16 moments included); the optax translation round-trips to the
        same tree."""
        opts = LAYOUTS[layout]
        _, path = _jax_file(tmp_path, jax_init, opts)
        with open(path, "rb") as f:
            want = serialization.msgpack_restore(f.read())
        got = flax_msgpack.load(path)
        _assert_tree_equal(got, want)
        view = from_jax_opt_state(got["opt_state"])
        back = to_jax_opt_state(view, TrainConfig(**opts))
        _assert_tree_equal(flax_msgpack.loads(flax_msgpack.dumps(flax_state_dict(back))),
                           want["opt_state"])

    def test_chunked_arrays_both_ways(self, tmp_path, jax_init, monkeypatch):
        """Leaves above MAX_CHUNK_SIZE (2**30 bytes; 4 KiB here) go as
        flat chunks: the port reads flax's and flax reads the port's."""
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
        run, path = _jax_file(tmp_path, jax_init, dict(adam_mu_dtype="bfloat16"), n_calls=1)
        raw = open(path, "rb").read()
        assert b"__msgpack_chunked_array__" in raw
        _assert_tree_equal(flax_msgpack.load(path), serialization.msgpack_restore(raw))
        tr = _port_trainer(dict(adam_mu_dtype="bfloat16"))
        mine = ckpt.save_checkpoint(str(tmp_path), 2, tr.jax_state_dict(2), fmt="msgpack")
        raw = open(mine, "rb").read()
        assert b"__msgpack_chunked_array__" in raw
        back = serialization.msgpack_restore(raw)
        for k, v in from_jax_params(back["params"]).items():
            assert torch.equal(v, tr.model.state_dict()[k]), k
        mu = from_jax_params(back["opt_state"]["inner_state"]["0"]["mu"], keep_dtype=True)
        assert all(v.dtype == torch.bfloat16 for v in mu.values())

    def test_reading_one_key_builds_only_its_tensors(self, tmp_path, jax_init, monkeypatch):
        """``keys=("params",)`` parses params and steps over the optimizer
        state by length prefixes: no tensor is made for the moments."""
        _, path = _jax_file(tmp_path, jax_init, ALL, n_calls=1)
        made = []
        real = flax_msgpack._tensor
        monkeypatch.setattr(flax_msgpack, "_tensor", lambda *a: made.append(1) or real(*a))
        got = flax_msgpack.load(path, keys=("params", "ema_params"))
        assert set(got) == {"params", "ema_params"}
        n_leaves = len(jax.tree_util.tree_leaves(jax_init))
        assert len(made) == 2 * n_leaves
        with pytest.raises(ValueError, match="no 'ema_params'"):
            from ml_music_style_transfer_tpu_torch.infer.synthesize import load_checkpoint_params

            p2 = jckpt.save_checkpoint(str(tmp_path), 5, {"params": jax_init, "epoch": 5})
            load_checkpoint_params(p2, use_ema=True)


class TestWriter:
    def test_bytes_equal_flax_serialize(self):
        """For numpy trees the writer's bytes are msgpack-python's under
        flax: the same shortest encodings, key order and extension types."""
        rng = np.random.default_rng(0)
        tree = {"i": {str(v): v for v in (0, 1, 127, 128, 255, 256, 65535, 65536, 2**32,
                                          -1, -32, -33, -128, -129, -32768, -2**31 - 1)},
                "f": 1.5, "inf": float("inf"), "b": True, "n": None,
                "s": {"short": "a", "mid": "x" * 40, "long": "y" * 300, "utf": "ä€"},
                "arr": {"f32": rng.standard_normal((3, 4)).astype(np.float32),
                        "i32": np.arange(5, dtype=np.int32), "u8": np.arange(4, dtype=np.uint8),
                        "f64": np.float64(2.5) * np.ones(2), "empty": np.zeros((0, 3), np.float32),
                        "scalar0d": np.asarray(7, np.int32)},
                "np": {"f32": np.float32(3.25), "i64": np.int64(-4)},
                "deep": {str(i): {"x": np.ones(i + 1, np.float32)} for i in range(20)}}
        # in_place: flax's copy by tree_map would sort the keys (order is
        # not meaning in a map; equal bytes need the same order)
        assert flax_msgpack.dumps(tree) == serialization.msgpack_serialize(tree, in_place=True)
        back = flax_msgpack.loads(flax_msgpack.dumps(tree))
        assert back["np"] == {"f32": 3.25, "i64": -4}  # numpy scalars come back as numbers
        del tree["np"], back["np"]
        _assert_tree_equal(back, serialization.msgpack_restore(serialization.msgpack_serialize(tree)))

    def test_bf16_and_complex_leaves(self):
        x = torch.randn(4, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
        raw = flax_msgpack.dumps({"w": x, "c": 1.5 - 2j})
        theirs = serialization.msgpack_restore(raw)
        assert theirs["c"] == 1.5 - 2j and theirs["w"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(theirs["w"], np.float32), x.float().numpy())
        ours = flax_msgpack.loads(raw)
        assert torch.equal(ours["w"], x) and ours["c"] == 1.5 - 2j


class TestCheckpointsAcrossPackages:
    @pytest.mark.parametrize("layout", ["default", "compact", "accum", "all"])
    def test_jax_run_resumed_by_the_port_continues_as_jax(self, tmp_path, jax_init, layout):
        """A JAX checkpoint (3 calls; with grad_accum 2 the accumulator is
        mid-cycle) loaded by the port's Trainer continues as the JAX
        Trainer continues it, on the same gradients."""
        opts = LAYOUTS[layout]
        run, path = _jax_file(tmp_path, jax_init, opts)
        tr = _port_trainer(opts, seed=7)  # another init: all from the file
        tr.load_state(ckpt.restore_checkpoint(path))
        assert tr.scheduler.state_dict() == run.tr.scheduler.state_dict()
        _assert_close_params(tr, run.params, 0)
        for s in (3, 4, 5):
            run.step(_grads(jax_init, s))
            _port_step(tr, _grads(jax_init, s))
        _assert_close_params(tr, run.params, 6)
        if "ema_decay" in opts:
            want = from_jax_params(jax.device_get(jget_param_ema(run.opt_state)))
            for k, v in tr.ema_state_dict().items():
                assert (v - want[k]).abs().max().item() <= 2e-8 + 0.02 * LR * 3, k

    @pytest.mark.parametrize("layout", ["default", "mu_bf16", "warmup_ema", "all"])
    def test_port_msgpack_restores_in_jax_and_continues_alike(self, tmp_path, jax_init, layout):
        """``save_checkpoint(..., fmt="msgpack")`` of ``jax_state_dict``:
        the JAX ``restore_checkpoint`` takes it into the JAX Trainer's own
        template, bit-equal to the port's state, and both continue alike."""
        opts = LAYOUTS[layout]
        tr = _port_trainer(opts)
        tr.model.load_state_dict(from_jax_params(jax_init))
        tr.optimizer = optim.build_optimizer(list(tr.model.named_parameters()), tr.cfg, LR,
                                             tr.device)
        for s in range(3):
            _port_step(tr, _grads(jax_init, s))
        tr.set_lr(7e-4)
        path = ckpt.save_checkpoint(str(tmp_path), 4, tr.jax_state_dict(4), fmt="msgpack")
        assert path.endswith("checkpoint-4.msgpack")
        run = _JaxRun(jax_init, opts)
        template = run.state(epoch=0)
        state = jckpt.restore_checkpoint(path, template)
        assert state["epoch"] == 4
        run.params, run.opt_state = state["params"], state["opt_state"]
        run.tr.scheduler.load_state_dict(state["scheduler"])
        got = from_jax_params(jax.device_get(state["params"]))
        for k, v in tr.model.state_dict().items():
            assert torch.equal(got[k], v), k
        assert float(optim_lr(state["opt_state"])) == pytest.approx(7e-4)
        if "ema_decay" in opts:
            ema = from_jax_params(jax.device_get(state["ema_params"]))
            for k, v in tr.ema_state_dict().items():
                assert torch.equal(ema[k], v), k
        for s in (3, 4):
            run.step(_grads(jax_init, s))
            _port_step(tr, _grads(jax_init, s))
        _assert_close_params(tr, run.params, 2)


def optim_lr(opt_state):
    from ml_music_style_transfer_tpu.train.optim import find_state

    return find_state(opt_state, lambda s: hasattr(s, "hyperparams")).hyperparams["learning_rate"]


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


@pytest.fixture(scope="module")
def user_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("user")
    notes = synthetic.random_song(np.random.default_rng(11), duration=6.0)
    midi, wav = str(d / "u.mid"), str(d / "u.wav")
    jmidi_writer.save(midi, notes)
    jaudio.write_wav(wav, synthetic.render_notes(notes, "harpsichord", 44100, 4.0), 44100)
    return midi, wav


class TestJaxTrainedServing:
    def test_jax_fit_served_by_both_synthesizers(self, tiny_h5, user_inputs, tmp_path,
                                                 monkeypatch):
        """The JAX Trainer's ``fit`` with ema_decay writes
        checkpoint-{best}.msgpack; both synthesizers serve it through
        ``params`` and ``ema_params`` (predicted spectrograms within
        1e-4 relative + 1e-4 of the peak, the float32 forward's tolerance
        in test_torch_port_serving.py); the port resumes the run."""
        monkeypatch.chdir(tmp_path)
        jcfg = JModelConfig(width_mult=1 / 16, compute_dtype="float32")
        JTrainer(jcfg, JTrainConfig(epochs=1, exp_name="j", batch_size=2, ema_decay=0.9),
                 use_native_loader=False).fit(tiny_h5)
        exp_dir = os.path.join("experiments", "j")
        assert ckpt.best_checkpoint(exp_dir)[0].endswith(".msgpack")
        midi, wav = user_inputs
        mcfg = ModelConfig(width_mult=1 / 16, compute_dtype="float32")
        specs = {}
        for use_ema in (False, True):
            js = JSynth(exp_dir, midi, wav, model_cfg=jcfg, use_ema=use_ema)
            ts = AudioSynthesizer(exp_dir, midi, wav, model_cfg=mcfg, use_ema=use_ema,
                                  device="cpu")
            want, jt = js._predict_device(midi, wav)
            got, tt = ts._predict_device(midi, wav)
            want = np.asarray(want)
            assert jt == tt and got.shape == want.shape
            err = float(np.abs(got.numpy() - want).max())
            print(f"use_ema={use_ema}: max |port - JAX| {err:.3e} on a peak of "
                  f"{np.abs(want).max():.4f}")  # shown with pytest -s
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
            specs[use_ema] = got
        assert not torch.equal(specs[False], specs[True])  # the EMA lags the weights
        # the port resumes the JAX run from its msgpack and goes on
        tr = Trainer(mcfg, TrainConfig(epochs=2, exp_name="j", batch_size=2, ema_decay=0.9),
                     device="cpu")
        _, exp = tr.fit(tiny_h5, resume=True, checkpoint_format="msgpack")
        assert len(exp.loss_history) == 2 and np.all(np.isfinite(exp.loss_history))

    def test_use_ema_without_an_ema_raises(self, tmp_path, jax_init, user_inputs):
        midi, wav = user_inputs
        mcfg = ModelConfig(width_mult=1 / 16, compute_dtype="float32")
        d = str(tmp_path)
        paths = [jckpt.save_checkpoint(d, 1, {"params": jax_init, "epoch": 1}),
                 ckpt.save_checkpoint(d, 2, {"params": from_jax_params(jax_init), "epoch": 2})]
        for p in paths:
            with pytest.raises(ValueError, match="--ema-decay"):
                AudioSynthesizer(d, midi, wav, model_cfg=mcfg, checkpoint_path=p, use_ema=True,
                                 device="cpu")
        tar = os.path.join(d, "checkpoint-3.tar")
        torch.save({"epoch": 3, "state_dict": from_jax_params(jax_init), "optimizer": None}, tar)
        with pytest.raises(ValueError, match="no EMA"):
            AudioSynthesizer(d, midi, wav, model_cfg=mcfg, checkpoint_path=tar, use_ema=True,
                             device="cpu")


class TestFitWithEma:
    def test_fit_ema_checkpoints_serves_and_resumes(self, tiny_h5, user_inputs, tmp_path,
                                                    monkeypatch, capsys):
        """Mirrors JAX test_train.py:330-366: ``fit`` evaluates the EMA
        weights and checkpoints them as ``ema_params``; the synthesizer
        and ``serve.py --use-ema`` serve them; a run without an EMA fails
        loudly under use_ema; resume keeps the EMA."""
        monkeypatch.chdir(tmp_path)
        mcfg = ModelConfig(width_mult=1 / 16, compute_dtype="float32")
        cfg = TrainConfig(epochs=2, exp_name="ema", batch_size=2, ema_decay=0.9)
        tr = Trainer(mcfg, cfg, device="cpu")
        _, exp = tr.fit(tiny_h5)
        exp_dir = os.path.join("experiments", "ema")
        state = ckpt.restore_checkpoint(ckpt.best_checkpoint(exp_dir)[0])
        assert set(state) == {"params", "opt_state", "epoch", "scheduler", "ema_params"}
        diffs = [float((state["params"][k] - state["ema_params"][k]).abs().max())
                 for k in state["params"]]
        assert max(diffs) > 1e-6
        from ml_music_style_transfer_tpu_torch.data.dataset import process_data

        ds = process_data(tiny_h5, None, None, cfg.seed)[1]  # fit's test split
        l_raw = tr.evaluate(ds)  # the weights after fit
        with tr.ema_weights():
            l_ema = tr.evaluate(ds)
        assert l_raw != l_ema
        assert exp.test_loss_history[-1] == pytest.approx(l_ema, rel=1e-6)  # ranked by the EMA
        midi, wav = user_inputs
        synth = AudioSynthesizer(exp_dir, midi, wav, model_cfg=mcfg, use_ema=True, device="cpu")
        for k, v in synth.model.state_dict().items():
            assert torch.equal(v, state["ema_params"][k]), k
        out = str(tmp_path / "o.wav")
        monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(
            {"midi": midi, "audio": wav, "out": out, "n_iter": 2}) + "\n"))
        assert serve.main(["-exp-name", "ema", "--width-mult", str(1 / 16), "--use-ema",
                           "--device", "cpu", "--pipeline-depth", "0"]) == 1
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"]
        assert os.path.exists(out)
        Trainer(mcfg, TrainConfig(epochs=1, exp_name="noema", batch_size=2),
                device="cpu").fit(tiny_h5)
        with pytest.raises(ValueError, match="ema"):
            AudioSynthesizer(os.path.join("experiments", "noema"), midi, wav, model_cfg=mcfg,
                             use_ema=True, device="cpu")
        Trainer(mcfg, TrainConfig(epochs=3, exp_name="ema", batch_size=2, ema_decay=0.9),
                device="cpu").fit(tiny_h5, resume=True)

    def test_cli_options_write_msgpack_the_jax_package_restores(self, tiny_h5, tmp_path,
                                                                monkeypatch):
        monkeypatch.chdir(tmp_path)
        train_cli.main(["-data-dir", tiny_h5, "-exp-name", "c", "--batch-size", "2",
                        "--width-mult", str(1 / 16), "--device", "cpu", "--ckpt-format",
                        "msgpack", "--adam-mu-dtype", "bfloat16", "--adam-nu-dtype", "bfloat16",
                        "--grads-dtype", "bfloat16", "--grad-clip-norm", "1.0",
                        "--warmup-steps", "2", "--ema-decay", "0.9", "--grad-accum", "2"])
        path, epoch = ckpt.latest_checkpoint(os.path.join("experiments", "c"))
        assert path.endswith(f"checkpoint-{epoch}.msgpack")
        opts = dict(ALL, warmup_steps=2)
        run = _JaxRun(jax.tree_util.tree_map(
            np.asarray, JTrainer(JModelConfig(width_mult=1 / 16), JTrainConfig(batch_size=2),
                                 use_native_loader=False).init_state(0)[0]), opts)
        state = jckpt.restore_checkpoint(path, run.state(epoch=0))
        assert state["epoch"] == epoch
        mu = state["opt_state"].inner_opt_state[1].inner_state[0].mu
        assert all(x.dtype == jnp.bfloat16 for x in jax.tree_util.tree_leaves(mu))
