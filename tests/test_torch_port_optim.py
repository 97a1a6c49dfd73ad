"""The port's optimizer options (``train/optim.py`` through the ``Trainer``)
against the JAX package's, on the CPU at width 1/16 in float32 with T = 220
and dropout off (the two frameworks draw dropout differently).

Two kinds of comparison:
  - teacher-forced: each step, the JAX gradient at the JAX parameters goes
    into both the JAX ``Trainer``'s transform (``self.tx``, after the
    ``grads_dtype`` round trip its ``train_step`` applies) and the port
    ``Trainer``'s optimizer. The parameters then differ only by the two
    optimizers' float32 rounding, so the tolerance is tight: within 2e-8
    absolute plus 2 % of one step's size (lr = 1e-3) per element. The loss
    of each step is the port's forward at its parameters against the JAX
    loss, within 1e-5 relative;
  - whole trajectories: each side with its own gradients. Adam's first
    steps are about lr * sign(grad), so float32 runs drift apart where a
    gradient sits at rounding level; the yardstick is the port's own
    float32-vs-float64 divergence on the same run (as
    ``test_torch_port_train.py``).
Inputs come from numpy seeds."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.config import TrainConfig as JTrainConfig
from ml_music_style_transfer_tpu.train import losses as jlosses
from ml_music_style_transfer_tpu.train.loop import Trainer as JTrainer
from ml_music_style_transfer_tpu.train.optim import get_param_ema as jget_param_ema
from ml_music_style_transfer_tpu.train.optim import scale_by_adam_compact
from ml_music_style_transfer_tpu_torch.compat import from_jax_params
from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.data.device_store import DeviceDataStore, gather_batch
from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
from ml_music_style_transfer_tpu_torch.train import optim
from ml_music_style_transfer_tpu_torch.train.loop import Trainer

T = 220
STEPS = 4
LR = 1e-3
TINY = dict(width_mult=1 / 16, compute_dtype="float32", dropout_rate=0.0)
ALL = dict(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16", grads_dtype="bfloat16",
           grad_clip_norm=1.0, warmup_steps=3, ema_decay=0.9, grad_accum=2)
OPTIONS = {
    "none": {},
    "adam_mu_dtype": dict(adam_mu_dtype="bfloat16"),
    "mu_and_nu": dict(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16"),
    "grads_dtype": dict(grads_dtype="bfloat16"),
    "clip_tight": dict(grad_clip_norm=1e-3),
    "clip_loose": dict(grad_clip_norm=1e3),
    "warmup": dict(warmup_steps=3),
    "ema": dict(ema_decay=0.9),
    "grad_accum": dict(grad_accum=2),
    "all": ALL,
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Tier-1 runs six test workers on one machine: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed, b=2):
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


@pytest.fixture(scope="module")
def jax_side():
    """A seeded flax init of the dropout-free tiny model, the batches, and
    one jitted (loss, gradient) of the JAX Trainer's L1 loss."""
    tr = JTrainer(JModelConfig(**TINY), JTrainConfig(batch_size=2), use_native_loader=False)
    params, _ = tr.init_state(0)

    def loss_fn(p, b):
        pred = tr.model.apply(p, b["midi"], b["cond"], b["onoff"], deterministic=True)
        return jlosses.l1_loss(pred, b["target"], b["weight"])

    return {"init": jax.tree_util.tree_map(np.asarray, params),
            "batches": [_batch(s) for s in range(STEPS)],
            "grad": jax.jit(jax.value_and_grad(loss_fn))}


def _port_trainer(init, opts, f64=False):
    cfg = TrainConfig(batch_size=2, learning_rate=LR, **opts)
    tr = Trainer(ModelConfig(**dict(TINY, compute_dtype="float64" if f64 else "float32")), cfg,
                 device="cpu")
    tr.init_state(0)
    tr.model.load_state_dict(from_jax_params(init))
    if f64:
        tr.model.double()
    # the optimizer (and an EMA) start from the loaded weights
    tr.optimizer = optim.build_optimizer(list(tr.model.named_parameters()), cfg, LR, tr.device)
    return tr


def _jax_tx_step(update, cfg, params, opt_state, grads):
    """The update of the JAX Trainer's train_step (loop.py:155-167) for
    given gradients; ``update`` is its jitted ``tx.update``."""
    if cfg.grads_dtype is not None:
        gd = jnp.dtype(cfg.grads_dtype)
        grads = jax.tree_util.tree_map(lambda g: g.astype(gd).astype(jnp.float32), grads)
    updates, opt_state = update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


def _set_grads(tr, grads_tree):
    g = from_jax_params(jax.device_get(grads_tree))
    for name, p in tr.model.named_parameters():
        p.grad = g[name].clone()


def _max_dev(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def _l2_dev(a, b):
    return sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in a) ** 0.5


def _state(tr):
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


def _teacher_forced(jax_side, opts, n_steps=STEPS, before_step=None):
    """Run both optimizers on the JAX gradients; returns the JAX and port
    losses and parameters per step, and both final states."""
    cfg = JTrainConfig(batch_size=2, learning_rate=LR, **opts)
    jtr = JTrainer(JModelConfig(**TINY), cfg, use_native_loader=False)
    params = jax.tree_util.tree_map(jnp.asarray, jax_side["init"])
    opt_state = jax.jit(jtr.tx.init)(params)
    update = jax.jit(jtr.tx.update)
    tr = _port_trainer(jax_side["init"], opts)
    out = {"jl": [], "tl": [], "jp": [], "tp": []}
    for i in range(n_steps):
        b = jax_side["batches"][i % STEPS]
        if before_step is not None:
            opt_state = before_step(i, jtr, opt_state, tr)
        loss, grads = jax_side["grad"](params, {k: jnp.asarray(v) for k, v in b.items()})
        with torch.no_grad():
            out["tl"].append(float(tr.loss(_torch(b), 0)))
        out["jl"].append(float(loss))
        params, opt_state = _jax_tx_step(update, cfg, params, opt_state, grads)
        tr.optimizer.zero_grad()
        _set_grads(tr, grads)
        tr.optimizer.step()
        out["jp"].append({k: v.double() for k, v in from_jax_params(jax.device_get(params)).items()})
        out["tp"].append(_state(tr))
    return out, (jtr, opt_state), tr


def _tight(jp, tp, steps_taken):
    """Element-wise: 2e-8 + 2 % of the updates' total size."""
    for k in jp:
        err = (tp[k].double() - jp[k]).abs().max().item()
        assert err <= 2e-8 + 0.02 * LR * max(steps_taken, 1), (k, err)


class TestTeacherForcedParity:
    """Per option: the port's optimizer against the JAX Trainer's
    transform on identical gradients, STEPS steps."""

    @pytest.mark.parametrize("name", list(OPTIONS))
    def test_option_matches_the_jax_trainer(self, jax_side, name):
        opts = OPTIONS[name]
        out, (jtr, opt_state), tr = _teacher_forced(jax_side, opts)
        k = opts.get("grad_accum", 1)
        np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-5)
        init = {n: v.double() for n, v in from_jax_params(jax_side["init"]).items()}
        for i, (jp, tp) in enumerate(zip(out["jp"], out["tp"])):
            _tight(jp, tp, (i + 1) // k)
        assert _max_dev(out["tp"][-1], init) > 1e-4  # the options did move the weights
        if k > 1:
            # the first k - 1 calls leave every weight bit-unchanged
            for n, v in from_jax_params(jax_side["init"]).items():
                assert torch.equal(out["tp"][0][n], v), n
        if "ema_decay" in opts:
            want = from_jax_params(jax.device_get(jget_param_ema(opt_state)))
            got = tr.ema_state_dict()
            for n in want:
                err = (got[n].double() - want[n].double()).abs().max().item()
                assert err <= 2e-8 + 0.02 * LR * (STEPS // k), (n, err)
            assert _max_dev(got, out["tp"][-1]) > 1e-5  # the EMA lags the weights
        if opts.get("adam_mu_dtype") == "bfloat16":
            mu = optim.export_state(tr.optimizer, list(got_names(tr)))["mu"]
            assert all(v.dtype == torch.bfloat16 for v in mu.values())

    def test_set_lr_reaches_the_inner_learning_rate_with_grad_accum(self, jax_side):
        """As the JAX test_train.py:98-106: with grad_accum and warmup the
        new learning rate reaches Adam; both sides are set to 5e-4 before
        the second cycle and must still agree."""
        opts = dict(grad_accum=2, warmup_steps=2)

        def set_lr(i, jtr, opt_state, tr):
            if i == 2:
                opt_state = jtr.set_lr(opt_state, 5e-4)
                tr.set_lr(5e-4)
            return opt_state

        out, _, tr = _teacher_forced(jax_side, opts, before_step=set_lr)
        for i, (jp, tp) in enumerate(zip(out["jp"], out["tp"])):
            _tight(jp, tp, (i + 1) // 2)
        assert tr.optimizer.param_groups[0]["lr"] == 5e-4
        # the second update moves no weight much further than the new lr
        # (at 1e-3 it would move many by about 1e-3)
        assert _max_dev(out["tp"][3], out["tp"][1]) < 0.75 * LR


def got_names(tr):
    return [n for n, _ in tr.model.named_parameters()]


class TestTrajectory:
    def test_all_options_trajectory_matches_jax(self, jax_side):
        """Each side with its own gradients, through the Trainers'
        train_step: loss trajectory within max(2 x the port's
        float32-vs-float64 divergence, 1e-4) relative, parameters within
        max(2 x that divergence, 1e-3 of their scale) and L2 within 2 x."""
        cfg = JTrainConfig(batch_size=2, learning_rate=LR, **ALL)
        jtr = JTrainer(JModelConfig(**TINY), cfg, use_native_loader=False)
        params = jax.tree_util.tree_map(jnp.asarray, jax_side["init"])
        opt_state = jax.jit(jtr.tx.init)(params)
        lj = []
        for b in jax_side["batches"]:
            params, opt_state, loss = jtr.train_step(
                params, opt_state, {k: jnp.asarray(v) for k, v in b.items()},
                jax.random.PRNGKey(0))
            lj.append(float(loss))
        lj, pj = np.asarray(lj), from_jax_params(jax.device_get(params))
        runs = {}
        for f64 in (False, True):
            tr = _port_trainer(jax_side["init"], ALL, f64=f64)
            dt = torch.float64 if f64 else torch.float32
            ls = [float(tr.train_step(_torch(b, dt), 0)) for b in jax_side["batches"]]
            runs[f64] = (np.asarray(ls), {k: v.double() for k, v in tr.model.state_dict().items()})
        (lt, pt), (l64, p64) = runs[False], runs[True]
        traj, null = np.max(np.abs(lt - lj) / lj), np.max(np.abs(l64 - lt) / lt)
        assert traj <= max(2 * null, 1e-4), (traj, null, lj, lt)
        scale = max(float(v.abs().max()) for v in pt.values())
        assert _max_dev(pt, pj) <= max(2 * _max_dev(p64, pt), 1e-3 * scale)
        assert _l2_dev(pt, pj) <= 2 * _l2_dev(p64, pt)
        assert lt[-1] < lt[0]


class TestCompactAdam:
    @pytest.mark.parametrize("mu,nu", [(None, None), ("bfloat16", None), (None, "bfloat16"),
                                       ("bfloat16", "bfloat16")])
    def test_matches_the_jax_scale_by_adam_compact(self, mu, nu):
        """As JAX test_train.py:108-126, on a toy tree: the update is the
        JAX compact transform's (and with no dtypes set optax.scale_by_adam's)
        within rtol 1e-5, atol 1e-7. Not 1e-6: XLA's float32 power makes
        b2 ** count about 1e-8 off, which the bias correction 1 - b2 ** count
        (1e-3 at the first step) turns into 7e-6 relative; the port's NumPy
        float32 power does not. The stored moments are the JAX ones (bf16
        ties may round one ulp apart: within 2^-8 relative)."""
        tree = {"a": np.linspace(-1, 1, 7).astype(np.float32),
                "b": (np.ones((3, 2)) * 0.1).astype(np.float32)}
        jt = scale_by_adam_compact(mu_dtype=mu, nu_dtype=nu)
        refs = [jt] + ([optax.scale_by_adam()] if mu is None and nu is None else [])
        states = [r.init(jax.tree_util.tree_map(jnp.asarray, tree)) for r in refs]
        params = {k: torch.zeros(v.shape) for k, v in tree.items()}
        opt = optim.CompactAdam(list(params.values()), lr=1.0,
                                mu_dtype=optim.storage_dtype(mu), nu_dtype=optim.storage_dtype(nu))
        rng = np.random.default_rng(0)
        for step in range(5):
            g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tree.items()}
            for p, k in zip(params.values(), tree):
                p.zero_()  # update = -(params after the step), exactly
                p.grad = torch.from_numpy(g[k])
            opt.step()
            for i, r in enumerate(refs):
                u, states[i] = r.update(jax.tree_util.tree_map(jnp.asarray, g), states[i])
                for k, p in zip(tree, params.values()):
                    np.testing.assert_allclose(-p.numpy(), np.asarray(u[k]), err_msg=f"{k}@{step}",
                                               rtol=1e-5, atol=1e-7)
        js = states[0]
        for j, k in enumerate(tree):
            for ours, theirs in ((opt.mu[j], js.mu[k]), (opt.nu[j], js.nu[k])):
                assert str(ours.dtype).split(".")[1] == str(theirs.dtype)
                np.testing.assert_allclose(ours.float().numpy(),
                                           np.asarray(theirs.astype(jnp.float32)),
                                           rtol=2.0 ** -8, atol=1e-30)
        assert opt.count == int(js.count) == 5

    def test_update_uses_the_float32_moments_not_the_stored_ones(self):
        """One step from zero moments: mu32 = 0.1 g exactly as float32, so
        the first update is g / (|g| + eps) with no bf16 rounding in it."""
        g = torch.tensor([0.3, -1.7, 2.9e-3])
        p = torch.zeros(3)
        p.grad = g.clone()
        opt = optim.CompactAdam([p], lr=1.0, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
        opt.step()
        torch.testing.assert_close(-p, g / (g.abs() + 1e-8), rtol=2e-7, atol=0)
        assert opt.mu[0].dtype == opt.nu[0].dtype == torch.bfloat16


class TestClip:
    @pytest.mark.parametrize("max_norm", [1e-3, 0.5, 1e3])
    def test_matches_optax_clip_by_global_norm(self, max_norm):
        rng = np.random.default_rng(1)
        tree = {"a": rng.standard_normal((5, 4)).astype(np.float32),
                "b": rng.standard_normal(3).astype(np.float32) * 0.1}
        want, _ = optax.clip_by_global_norm(max_norm).update(
            jax.tree_util.tree_map(jnp.asarray, tree), optax.EmptyState())
        grads = [torch.from_numpy(tree[k].copy()) for k in tree]
        norm = optim.clip_by_global_norm_(grads, max_norm)
        assert float(norm) == pytest.approx(float(optax.global_norm(tree)), rel=1e-6)
        for g, k in zip(grads, tree):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
        if max_norm == 1e3:  # below the threshold: untouched, bit for bit
            assert all(np.array_equal(g.numpy(), tree[k]) for g, k in zip(grads, tree))


class TestTrainerOptions:
    def test_default_optimizer_is_still_plain_adam(self):
        tr = Trainer(ModelConfig(**TINY), TrainConfig(batch_size=2), device="cpu")
        tr.init_state(0)
        assert type(tr.optimizer) is torch.optim.Adam
        assert not optim.has_options(TrainConfig(adam_mu_dtype="float32", grads_dtype="float32"))
        tr = Trainer(ModelConfig(**TINY), TrainConfig(batch_size=2, **ALL), device="cpu")
        tr.init_state(0)
        assert isinstance(tr.optimizer, optim.TrainOptimizer)
        assert isinstance(tr.optimizer.adam, optim.CompactAdam)

    def test_resident_steps_honour_every_option(self, jax_side):
        """``train_step_resident`` uses the same optimizer: two resident
        microbatch calls equal two host-fed calls on the gathered batches,
        bit for bit, and the first leaves the weights unchanged."""
        rng = np.random.default_rng(4)
        raw = {"pianoroll": (rng.random((6, 860, 128)) < 0.05).astype(np.float32),
               "onoff": rng.integers(-1, 2, (6, 860, 128)).astype(np.float32),
               "audio_cuba": (rng.standard_normal((6, 219904)) * 0.05).astype(np.float32)}
        store = DeviceDataStore.from_arrays(raw, device="cpu", audio_dtype=torch.float32)
        plan = store.draw_epoch_indices(2)
        idx = [next(plan) for _ in range(2)]
        a = _port_trainer(jax_side["init"], ALL)
        b = _port_trainer(jax_side["init"], ALL)
        w0 = _state(a)
        for i, (x, y, z) in enumerate(idx):
            la = a.train_step_resident(store.audio, store.pianoroll, store.onoff, x, y, z, 3)
            lb = b.train_step(gather_batch(store.audio, store.pianoroll, store.onoff, x, y, z), 3)
            assert torch.equal(la, lb)
            if i == 0:
                assert all(torch.equal(v, w0[k]) for k, v in a.model.state_dict().items())
        for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            assert torch.equal(va, vb), k
        assert _max_dev(a.model.state_dict(), w0) > 1e-4
        assert all(torch.equal(x, y) for x, y in zip(a.optimizer.ema.ema, b.optimizer.ema.ema))

    def test_restore_continues_bit_identically_with_every_option(self, tmp_path, jax_side):
        """The .pt carries the moments (bf16), the EMA, the accumulator
        mid-cycle, the mini-step and the warmup count."""
        batches = [_torch(b) for b in jax_side["batches"]]
        a = _port_trainer(jax_side["init"], ALL)
        for b in batches[:3]:  # one applied update, then a microbatch of the next
            a.train_step(b, 0)
        a.set_lr(5e-4)
        path = ckpt.save_checkpoint(str(tmp_path), 1, a.state_dict(1))
        state = ckpt.restore_checkpoint(path)
        assert set(state) == {"params", "opt_state", "epoch", "scheduler", "ema_params"}
        assert state["opt_state"]["mini_step"] == 1 and state["opt_state"]["warmup_count"] == 1
        b_ = Trainer(ModelConfig(**TINY), TrainConfig(batch_size=2, learning_rate=LR, **ALL),
                     device="cpu")
        b_.init_state(seed=123)  # another init: everything must come from the file
        b_.load_state(state)
        assert b_.optimizer.param_groups[0]["lr"] == 5e-4
        for t in (a, b_):
            t.train_step(batches[3], 0)  # completes the cycle: an update
            t.train_step(batches[0], 0)
        for (k, va), vb in zip(a.model.state_dict().items(), b_.model.state_dict().values()):
            assert torch.equal(va, vb), k
        for x, y in zip(a.optimizer.ema.ema + a.optimizer.acc + a.optimizer.adam.mu,
                        b_.optimizer.ema.ema + b_.optimizer.acc + b_.optimizer.adam.mu):
            assert torch.equal(x, y)

    def test_a_state_of_other_options_is_refused(self, jax_side):
        a = _port_trainer(jax_side["init"], dict(ema_decay=0.9))
        b = _port_trainer(jax_side["init"], {})
        with pytest.raises(ValueError, match="other optimizer options"):
            optim.import_state(b.optimizer, a.optimizer.state_dict(), got_names(b))
        with pytest.raises(ValueError, match="ema_decay"):
            b.ema_state_dict()
