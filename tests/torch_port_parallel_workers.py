"""Rank functions for the port's multi-device tests, run by
``ml_music_style_transfer_tpu_torch.parallel.launch.spawn`` on gloo ranks.

Kept apart from the test modules: a spawned rank imports this module, and
it imports torch and the port only (no JAX), so each rank starts in about
a second. Every function takes the rank first and returns what the test
compares (numpy arrays and floats).
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.models import PerformanceNet, layers
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as dk
from ml_music_style_transfer_tpu_torch.parallel import gl_shard
from ml_music_style_transfer_tpu_torch.parallel import mesh as pmesh
from ml_music_style_transfer_tpu_torch.parallel import time_shard as ts

# width 1/16, float32, no dropout: the train steps compare with the JAX
# Trainer, whose dropout draws threefry bits (layers.py:56)
TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32", dropout_rate=0.0)
TS_KW = dict(start_channels=32, start_audio_channels=65, width_mult=1 / 16,
             compute_dtype="float32")


def _np(t):
    """A numpy copy (a state_dict's tensors share the live weights)."""
    return t.detach().cpu().numpy().copy()


def _state_np(sd):
    return {k: _np(v) for k, v in sd.items()}


def _train(trainer, batch, n_steps=2):
    from ml_music_style_transfer_tpu_torch.train.loop import stage_batch

    local = stage_batch(trainer.shard_batch(batch), trainer.device)
    return [float(trainer.train_step(local, s)) for s in range(n_steps)]


def _moment_bytes(opt) -> int:
    """Bytes of Adam's moments on this rank."""
    from ml_music_style_transfer_tpu_torch.train import optim

    inner = opt.inner if isinstance(opt, optim.ZeroOptimizer) else opt
    if isinstance(inner, optim.TrainOptimizer):
        _, mu, nu = inner.moments()
    else:
        _, mu, nu = optim.adam_moments(inner)
    return pmesh.per_rank_bytes(list(mu) + list(nu))


def mesh_training(rank, batch, runs, tmp):
    """Each run (name, (data, model, dcn), TrainConfig kwargs): a Trainer on
    that mesh takes two steps on the global ``batch``. Returns {name:
    {"losses", "params" (whole, rank 0 only), "moment_bytes"}} plus the
    checkpoint, resident-store and dropout checks of the last mesh."""
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer

    cfg = ModelConfig(**TINY_KW)
    b = len(batch["weight"])
    out = {}
    for name, (data, model, dcn), kw in runs:
        mesh = pmesh.make_mesh(data, model, dcn=dcn, device="cpu")
        tr = Trainer(cfg, TrainConfig(batch_size=b, **kw), device="cpu", mesh=mesh)
        tr.init_state(0)
        losses = _train(tr, batch)
        full = tr.model.full_state_dict()
        out[name] = {"losses": losses, "moment_bytes": _moment_bytes(tr.optimizer),
                     "params": _state_np(full) if rank == 0 else None}
        if name == "zero_tp":
            out["checkpoint"] = _checkpoint_roundtrip(rank, tr, cfg, b, kw, mesh, batch, tmp)
    out["resident"] = resident_and_dropout(rank)
    return out


def _checkpoint_roundtrip(rank, tr, cfg, b, kw, mesh, batch, tmp):
    """A ZeRO + TP trainer's state, gathered whole, saved (.pt and flax
    msgpack) and loaded into fresh trainers: the whole tensors survive and
    the next step equals the step of the trainer never saved."""
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer

    import copy

    st = copy.deepcopy(tr.state_dict(2))  # its tensors may share the live ones
    jst = tr.jax_state_dict(2)
    if rank == 0:
        ckpt.save_checkpoint(tmp, 2, st, "torch")
        ckpt.save_checkpoint(tmp, 2, jst, "msgpack")
    dist.barrier()
    want = _train(tr, batch, 1)[0]
    want_params = tr.model.full_state_dict()
    res = {"want_loss": want}
    for fmt in ("torch", "msgpack"):
        t2 = Trainer(cfg, TrainConfig(batch_size=b, **kw), device="cpu", mesh=mesh)
        t2.init_state(1)
        t2.load_state(ckpt.restore_checkpoint(ckpt.checkpoint_path(tmp, 2, fmt)))
        same = all(torch.equal(st["params"][k], v) for k, v in
                   t2.model.full_state_dict().items())
        opt = t2._opt_state()
        same_opt = all(torch.equal(st["opt_state"][key][k], v)
                       for key in ("mu", "nu") for k, v in opt[key].items())
        loss = _train(t2, batch, 1)[0]
        diff = max(float((v - want_params[k]).abs().max())
                   for k, v in t2.model.full_state_dict().items())
        res[fmt] = {"params_equal": same, "moments_equal": same_opt, "loss": loss,
                    "max_param_diff": diff}
    return res


def resident_and_dropout(rank):
    """On a (2, 2) mesh: a data-sharded store's local batches against a
    replicated store's, a ZeRO step on each, and train-mode forwards whose
    dropout masks must agree across model ranks and differ across data
    ranks."""
    from ml_music_style_transfer_tpu_torch.data.device_store import DeviceDataStore
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer

    mesh = pmesh.make_mesh(2, 2, device="cpu")
    rng = np.random.default_rng(5)
    n, t = 9, 220  # 9 rows over 2 data ranks: 5 each, one of them padding
    raw = {"pianoroll": (rng.random((n, t, 128)) < 0.05).astype(np.int8),
           "onoff": rng.choice([-1, 0, 1], (n, t, 128)).astype(np.int8),
           "audio_a": rng.standard_normal((n, (t - 1) * 256)).astype(np.float32),
           "audio_b": rng.standard_normal((n, (t - 1) * 256)).astype(np.float32)}
    rep = DeviceDataStore.from_arrays(raw, audio_dtype=torch.float32, device="cpu", mesh=mesh,
                                      seed=3)
    shd = DeviceDataStore.from_arrays(raw, audio_dtype=torch.float32, device="cpu", mesh=mesh,
                                      seed=3, store_sharding="data")
    out = {"rows_held": int(shd.pianoroll.shape[0]), "batches_equal": True}
    cfg = ModelConfig(**TINY_KW)
    losses = {}
    for name, store in (("replicated", rep), ("data", shd)):
        tr = Trainer(cfg, TrainConfig(batch_size=4, zero_opt=True), device="cpu", mesh=mesh)
        tr.init_state(0)
        losses[name] = [float(tr.train_step(store.local_batch(*ix), 7))
                        for ix in store.draw_epoch_indices(4)]
    for (i1, c1, s1), (i2, c2, s2) in zip(rep.draw_epoch_indices(4),
                                          shd.draw_epoch_indices(4)):
        b1, b2 = rep.local_batch(i1, c1, s1), shd.local_batch(i2, c2, s2)
        out["batches_equal"] &= all(torch.equal(b1[k], b2[k]) for k in b1)
    out["losses"] = losses
    # dropout: the same input on every rank, train mode
    model = PerformanceNet(ModelConfig(width_mult=1 / 16, compute_dtype="float32"),
                           generator=torch.Generator().manual_seed(0))
    model.shard_tensor_parallel_(pmesh.axis_group(mesh, "model"))
    x = np.random.default_rng(1)
    midi = torch.from_numpy((x.random((1, 220, 128)) < 0.05).astype(np.float32))
    spec = torch.from_numpy(x.random((1, 220, 1025)).astype(np.float32))
    seed = dk.fold_seed(12345, pmesh.batch_rank(mesh))
    with torch.no_grad():
        y = model(midi, spec, midi, deterministic=False, dropout_seed=seed)
    out["coords"] = (pmesh.axis_rank(mesh, "data"), pmesh.axis_rank(mesh, "model"))
    out["train_out"] = _np(y)
    return out


# ---- time sharding -------------------------------------------------------------

def block_outputs(rank, inputs):
    """Every block on a 2-rank time axis; returns this rank's slices
    (channel-last, as the JAX functions give them)."""
    mesh = pmesh.make_axis_mesh(2, "data", device="cpu")
    g = pmesh.axis_group(mesh, "data")
    out = {}

    def local(a):  # (B, T, C) numpy -> this rank's channel-first slice
        return ts.shard_time(torch.from_numpy(a), mesh, "data").transpose(1, 2)

    def cl(t):
        return _np(t.transpose(1, 2))

    x, w, b = inputs["block"]
    conv_w = torch.from_numpy(w).permute(2, 1, 0).contiguous()
    out["block"] = cl(ts.sharded_conv_block(local(x), conv_w, torch.from_numpy(b), g))
    xe, we, be = inputs["edges"]
    out["block_edges"] = cl(ts.sharded_conv_block(
        local(xe), torch.from_numpy(we).permute(2, 1, 0).contiguous(), torch.from_numpy(be), g))
    out["instance_norm"] = cl(ts.sharded_instance_norm(local(inputs["in"]), g))
    xm, t_valid = inputs["masked_in"]
    out["masked_in"] = cl(ts.masked_instance_norm(local(xm), t_valid, g))
    for s in (1, 2, 6):
        out[f"right{s}"] = cl(ts._shift_right(local(inputs["shift"]), s, g))
        out[f"left{s}"] = cl(ts._shift_left(local(inputs["shift"]), s, g))
    for k in (6, 4, 3, 2):
        xk, t_valid = inputs[f"convT{k}"]
        ct = layers.ConvTranspose1dTorch(12, 20, k, 2, 1, "float32")
        with torch.no_grad():
            ct.weight.copy_(torch.from_numpy(inputs[f"convT{k}_w"]))
            ct.bias.copy_(torch.from_numpy(inputs[f"convT{k}_b"]))
            y = ts._mask(ts._conv_transpose_s2(local(xk), ct, g), 2 * t_valid + k - 4, g)
        out[f"convT{k}"] = cl(y)
    xd, t_valid = inputs["down"]
    dc = layers.DownConv(16, 24, True, "float32")
    dc.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["down_sd"].items()})
    with torch.no_grad():
        pooled, _, before, _ = ts.sharded_down_conv(dc, local(xd), t_valid, g)
    out["down_pooled"], out["down_before"] = cl(pooled), cl(before)
    return out


def time_sharded(rank, block_inputs, state, inputs, t_valid, n_steps):
    """``block_outputs``, then the time-sharded forward, loss and gradients
    of a TS-config model holding ``state`` on a 2-rank axis and
    ``n_steps`` fine-tune steps."""
    out = {"blocks": block_outputs(rank, block_inputs)}
    mesh = pmesh.make_axis_mesh(2, "time", device="cpu")
    model = PerformanceNet(ModelConfig(**TS_KW), device="meta")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, assign=True)
    fn, t_pad, t_out = ts.make_time_sharded_forward(model, mesh, t_valid)

    def pad_local(a, t_to):
        p = np.zeros((1, t_pad, a.shape[-1]), np.float32)
        p[:, :t_to] = a[:, :t_to]
        return ts.shard_time(torch.from_numpy(p), mesh)

    xm, xa, xc = (pad_local(inputs[k], t_valid) for k in ("xm", "xa", "xc"))
    with torch.no_grad():
        fwd = _np(fn(xm, xa, xc))
    tst = ts.make_time_sharded_train_step(model, mesh, t_valid)
    tgt = pad_local(inputs["target"], tst.t_out)
    loss, grads = tst.value_and_grad(xm, xa, xc, tgt)
    steps = [float(tst.step(xm, xa, xc, tgt)) for _ in range(n_steps)]
    out.update({"forward": fwd, "t_pad": t_pad, "t_out": t_out, "loss": float(loss),
                "grads": {k: _np(v) for k, v in grads.items()} if rank == 0 else None,
                "steps": steps})
    return out


# ---- Griffin-Lim ------------------------------------------------------------------

def sharded_gl(rank, n, spec, field, kw, specs, bulk_fields, clip_dir):
    """Sharded Griffin-Lim on an n-rank time axis from ``field``; seed
    determinism; the ValueErrors; bulk Griffin-Lim over the data ranks
    (from the seeds, and from ``bulk_fields``); on 2 ranks the serving
    daemon over the mesh."""
    mesh = pmesh.make_axis_mesh(n, "time", device="cpu")
    out = {"wav": _np(gl_shard.sharded_griffinlim_from_log_power(
        spec, mesh, init_phase=torch.from_numpy(field), device="cpu", **kw))}
    small = dict(n_iter=6, hop_length=kw["hop_length"], halo=4, rounds=3)
    a, b, c = (_np(gl_shard.sharded_griffinlim_from_log_power(spec[:96], mesh, seed=s,
                                                              **small))
               for s in (5, 5, 6))
    out["same_seed_equal"] = bool(np.array_equal(a, b))
    out["other_seed_differs"] = not np.array_equal(a, c)
    errors = []
    for bad in (dict(spec=spec[:n * 12 + 1], halo=4), dict(spec=spec[:n * 8], halo=8)):
        try:
            gl_shard.sharded_griffinlim_from_log_power(bad["spec"], mesh, n_iter=2,
                                                       hop_length=kw["hop_length"],
                                                       halo=bad["halo"])
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    dmesh = pmesh.make_mesh(n, 1, device="cpu")
    from ml_music_style_transfer_tpu_torch.infer import bulk

    out["bulk"] = _np(bulk.bulk_griffinlim(specs, list(range(len(specs))), mesh=dmesh,
                                           n_iter=3, hop_length=kw["hop_length"]))
    out["per_clip"] = np.stack([_np(tgl.griffinlim_from_log_power(
        s, generator=torch.Generator().manual_seed(i), n_iter=3, hop_length=kw["hop_length"],
        device="cpu")) for i, s in enumerate(specs)])
    out["bulk_from_fields"] = _np(bulk.bulk_griffinlim(
        specs, list(range(len(specs))), mesh=dmesh, n_iter=3, hop_length=kw["hop_length"],
        init_phase=torch.from_numpy(bulk_fields)))
    if clip_dir is not None:
        out["daemon"] = _daemon(rank, dmesh, clip_dir)
    return out


def _daemon(rank, mesh, clip_dir):
    """The serving daemon on a 2-rank mesh: rank 0 reads a batch and five
    whole-clip requests, rank 1 follows. ``c.mid`` is missing on rank 1
    (its ``make_synth`` looks for it elsewhere), as a file one host lacks.
    Rank 0 returns the responses, rank 1 the count it ran; both return the
    sharded Griffin-Lim of clip a's one-device forward."""
    import io
    import json

    from ml_music_style_transfer_tpu_torch.infer.synthesize import AudioSynthesizer
    from ml_music_style_transfer_tpu_torch.scripts import serve

    state = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(clip_dir, "state.npz")).items()}
    cfg = ModelConfig(width_mult=1 / 16, compute_dtype="float32")

    def make_synth(m, a):
        if rank != 0 and os.path.basename(m) == "c.mid":
            m = os.path.join(clip_dir, "absent", "c.mid")
        return AudioSynthesizer(clip_dir, m, a, model_cfg=cfg, params=state, device="cpu")

    midi, wav = (os.path.join(clip_dir, f) for f in ("a.mid", "a.wav"))
    if rank != 0:
        out = {"followed": serve.follow(make_synth, mesh)}
    else:
        midi2, midi3 = (os.path.join(clip_dir, f) for f in ("b.mid", "c.mid"))

        def whole(m, name, **kw):
            return {"midi": m, "audio": wav, "out": os.path.join(clip_dir, name), "n_iter": 2,
                    "whole_clip": True, **kw}

        reqs = [{"batch": [{"midi": midi, "audio": wav, "out": os.path.join(clip_dir, "m0.wav")},
                           {"midi": "/nonexistent.mid", "audio": wav,
                            "out": os.path.join(clip_dir, "m1.wav")},
                           {"midi": midi2, "audio": wav, "out": os.path.join(clip_dir, "m2.wav")},
                           {"midi": midi3, "audio": wav, "out": os.path.join(clip_dir, "m3.wav")}],
                 "n_iter": 2},
                whole(midi, "w0.wav", shard_gl=False),
                whole(midi, "w1.wav", shard_gl=True, gl_halo=8, gl_rounds=2),
                whole(midi3, "w2.wav", shard_gl=True, gl_halo=8, gl_rounds=2),
                whole(midi, "w3.wav", shard_gl=True, gl_halo=100000),
                whole(midi2, "w4.wav")]
        out_s = io.StringIO()
        served = serve.serve_loop(make_synth, io.StringIO("\n".join(json.dumps(r) for r in reqs)
                                                          + "\n"), out_s, mesh=mesh)
        out = {"served": served,
               "responses": [json.loads(line) for line in out_s.getvalue().splitlines()]}
    # the daemon's sharded request's Griffin-Lim on one device's forward
    synth = make_synth(midi, wav)
    roll, onoff, cond, t_total = synth.process_whole_clip(midi, wav)
    spec = synth.predict_spectrogram_whole_clip(roll, onoff, cond, t_total)
    hp = synth.hp
    full = np.zeros((ts.padded_length(t_total, 2, synth.model.cfg.depth), spec.shape[1]),
                    np.float32)
    full[:spec.shape[0]] = spec
    out["one_device_sharded_gl"] = _np(gl_shard.sharded_griffinlim_from_log_power(
        full, mesh, axis_name="data", n_iter=2, hop_length=hp.ws, clip_max=hp.clip_log_power_max,
        halo=8, seed=0, rounds=2))[:spec.shape[0] * hp.ws]
    return out


# ---- sharded checkpoints -------------------------------------------------------

def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree) if isinstance(tree, torch.Tensor) else tree


def sharded_checkpoints(rank, batch, tmp, h5):
    """A ZeRO-1 + TP trainer with an EMA on a (2, 2) mesh saves a ``.dcp``
    and takes a step while the write goes on. Returns what the test
    compares: the whole state at the save, the gathers made while saving,
    the whole states restored into a fresh trainer of the same mesh and of
    a (4, 1) mesh, the continuation steps of the saved and the restored
    trainer, and a ZeRO-1 ``fit`` -> resume from ``.dcp``."""
    from ml_music_style_transfer_tpu_torch.parallel import comm
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer

    cfg = ModelConfig(**TINY_KW)
    kw = dict(batch_size=len(batch["weight"]), zero_opt=True, ema_decay=0.9)
    mesh = pmesh.make_mesh(2, 2, device="cpu")
    tr = Trainer(cfg, TrainConfig(**kw), device="cpu", mesh=mesh)
    tr.init_state(0)
    _train(tr, batch, 1)
    out = {"want": _tree_np(tr.state_dict(1))}  # whole, gathered before the save
    gathers = []
    real = comm.all_gather_cat

    def spy(x, group, dim):
        gathers.append(tuple(x.shape))
        return real(x, group, dim)

    comm.all_gather_cat = spy
    try:
        path = ckpt.save_checkpoint_sharded(tmp, 1, tr.sharded_state_dict(1))
    finally:
        comm.all_gather_cat = real
    out["save_gathers"] = gathers
    out["moment_bytes"] = _moment_bytes(tr.optimizer)
    out["flush_step_loss"] = _train(tr, batch, 1)[0]  # in place, during the write
    ckpt.wait_for_async_saves()
    out["next_params"] = _state_np(tr.model.full_state_dict())
    for name, shape in (("same_mesh", (2, 2)), ("other_mesh", (4, 1))):
        m = mesh if shape == (2, 2) else pmesh.make_mesh(*shape, device="cpu")
        t2 = Trainer(cfg, TrainConfig(**kw), device="cpu", mesh=m)
        t2.init_state(1)
        res = {"epoch": t2.load_sharded_state(path), "state": _tree_np(t2.state_dict(1))}
        res["step_loss"] = _train(t2, batch, 1)[0]
        res["next_params"] = _state_np(t2.model.full_state_dict())
        out[name] = res
    if rank == 0:
        out["files"] = {f: os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)}
    out["fit"] = _zero_fit_resume(rank, cfg, mesh, h5, os.path.join(tmp, "exp"))
    return out


def _zero_fit_resume(rank, cfg, mesh, h5, exp_root):
    """``fit`` one epoch with ZeRO-1 and ``"dcp"``, then resume it for a
    second: the optimizer state at the resumed epoch's start, gathered
    whole, against the checkpoint's."""
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer

    def tcfg(epochs):
        return TrainConfig(epochs=epochs, test_freq=1, exp_name="zfit", batch_size=2,
                           zero_opt=True)

    Trainer(cfg, tcfg(1), exp_root=exp_root, device="cpu", mesh=mesh).fit(
        h5, checkpoint_format="dcp")
    seen = {}
    tr = Trainer(cfg, tcfg(2), exp_root=exp_root, device="cpu", mesh=mesh)
    real = tr.train_epoch

    def spy(*a, **k):
        if not seen:
            seen["opt"] = _tree_np(tr._opt_state())
            seen["moment_bytes"] = _moment_bytes(tr.optimizer)
        return real(*a, **k)

    tr.train_epoch = spy
    _, exp = tr.fit(h5, resume=True, checkpoint_format="dcp")
    exp_dir = os.path.join(exp_root, "zfit")
    path, epoch = ckpt.latest_checkpoint(exp_dir)
    out = {"loss_history": exp.loss_history, "latest": os.path.basename(path),
           "moment_bytes": seen["moment_bytes"]}
    if rank == 0:
        first = ckpt.restore_checkpoint(ckpt.checkpoint_path(exp_dir, 1, "dcp"))
        out["resumed_opt_equal"] = all(
            np.array_equal(seen["opt"][key][n], _np(first["opt_state"][key][n]))
            for key in ("mu", "nu") for n in first["opt_state"][key])
        out["listing"] = sorted(os.listdir(exp_dir))
    return out


# ---- parameter bytes per rank ----------------------------------------------------

def param_bytes(rank):
    """On a (1, 2) mesh: ``per_device_param_bytes`` of a tensor-parallel
    width-1/16 model, and of a DTensor sharded over the model axis."""
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh = pmesh.make_mesh(1, 2, device="cpu")
    model = PerformanceNet(ModelConfig(**TINY_KW), generator=torch.Generator().manual_seed(0))
    whole = pmesh.per_device_param_bytes(model)
    model.shard_tensor_parallel_(pmesh.axis_group(mesh, "model"))
    dt = distribute_tensor(torch.zeros(6, 4), mesh["model"], [Shard(0)])
    return {"whole": whole, "tp": pmesh.per_device_param_bytes(model),
            "dtensor": pmesh.per_device_param_bytes({"w": dt, "b": torch.zeros(3)})}


# ---- orbax checkpoints on a mesh ---------------------------------------------------

ORBAX_MESHES = ((2, 2), (4, 1))


def _gather_spy():
    """(restore, dtypes): every tensor an all-gather moves while the spy is
    on (``comm.all_gather_cat``, and torch's all-gathers, which also carry
    ``all_gather_object``'s pickles as uint8) is recorded by its dtype."""
    from torch.distributed import distributed_c10d as c10d

    from ml_music_style_transfer_tpu_torch.parallel import comm

    seen = []
    real = {(m, n): getattr(m, n) for m in (dist, c10d)
            for n in ("all_gather", "all_gather_into_tensor")}
    real_cat = comm.all_gather_cat

    def wrap(fn, pick):
        def spy(*a, **k):
            seen.append(str(pick(*a, **k).dtype))
            return fn(*a, **k)
        return spy

    for (m, n), fn in real.items():
        setattr(m, n, wrap(fn, lambda out, x, *a, **k: x))
    comm.all_gather_cat = wrap(real_cat, lambda x, *a, **k: x)

    def restore():
        for (m, n), fn in real.items():
            setattr(m, n, fn)
        comm.all_gather_cat = real_cat
    return restore, seen


def _regions(tree):
    """{key path: (offset, size)} of the ``Shard`` leaves of a JAX-layout tree."""
    from ml_music_style_transfer_tpu_torch.train import orbax_format

    return {k: (b.offset, b.size) for k, b in orbax_format.shards(tree).items()}


def _boxes(tree):
    """{key path: (shape, offset, size, dtype, written)} of the ``Shard``
    leaves of a JAX-layout tree."""
    from ml_music_style_transfer_tpu_torch.train import orbax_format

    return {k: (b.shape, b.offset, b.size, b.dtype, b.write)
            for k, b in orbax_format.shards(tree).items()}


def _jax_np(tr, epoch):
    """The trainer's whole JAX-layout state (gathered), in flax's layout."""
    from ml_music_style_transfer_tpu_torch.compat import weights

    return _tree_np(weights.flax_state_dict(tr.jax_state_dict(epoch)))


def _restore_orbax(cfg, tkw, shape, path):
    """A fresh trainer of ``shape`` restores ``path``: (epoch, whole state,
    bytes read, the regions this rank read)."""
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer

    tr = Trainer(cfg, TrainConfig(**tkw), device="cpu",
                 mesh=pmesh.make_mesh(*shape, device="cpu"))
    tr.init_state(1)
    stats = {}
    epoch = tr.load_orbax_sharded(path, stats)
    regions = _regions({k: v for k, v in tr.orbax_state(0).items() if k != "ema_params"})
    return {"epoch": epoch, "state": _jax_np(tr, 1), "value_bytes": stats["value_bytes"],
            "regions": regions}


def orbax_mesh(rank, batch, tmp, jax_dir, jax_msgpack, h5):
    """Orbax checkpoints on (2, 2) and (4, 1) meshes with ZeRO-1 and an EMA:
    each mesh's trainer saves its own blocks (the all-gathers seen while
    it saves; each rank's blocks against ``loop.rank_orbax_state``'s) and
    fresh trainers of both meshes restore it; rank 0 plays the 4 ranks of
    the (2, 2) save in turn into a second directory; a rank whose write
    fails; ``fit`` with ``"orbax"`` on the (2, 2) mesh and its resume; the
    JAX package's (2, 2) directory restored on both meshes, and its
    msgpack. The JAX package's directory is written by the calling process
    while the ranks run: they wait for it, last."""
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train import loop, orbax_format
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer

    cfg = ModelConfig(**TINY_KW)
    tkw = dict(batch_size=len(batch["weight"]), zero_opt=True, ema_decay=0.9)
    out = {}
    for shape in ORBAX_MESHES:
        name = f"{shape[0]}x{shape[1]}"
        tr = Trainer(cfg, TrainConfig(**tkw), device="cpu",
                     mesh=pmesh.make_mesh(*shape, device="cpu"))
        tr.init_state(0)
        _train(tr, batch, 1)
        res = {"want": _jax_np(tr, 1)}
        restore, seen = _gather_spy()
        try:
            path = ckpt.save_checkpoint_orbax(os.path.join(tmp, name), 1, tr.orbax_state(1),
                                              wait=True)
        finally:
            restore()
        res["save_gathers"], res["path"] = seen, path
        res["restored"] = {f"{s[0]}x{s[1]}": _restore_orbax(cfg, tkw, s, path)
                           for s in ORBAX_MESHES}
        whole = tr.state_dict(1)  # a collective: every rank
        axes = {"data": shape[0], "model": shape[1]}
        res["boxes"] = (_boxes(tr.orbax_state(1)),
                        _boxes(loop.rank_orbax_state(whole, tr.cfg, axes, rank)))
        if shape == (2, 2):
            if rank == 0:  # one process plays the 4 ranks
                play = os.path.join(tmp, "played", "checkpoint-1.orbax")
                os.makedirs(f"{play}.tmp")
                blocks = [loop.rank_orbax_state(whole, tr.cfg, axes, r) for r in range(4)]
                entries = [orbax_format.write_shards(f"{play}.tmp", r, b)
                           for r, b in enumerate(blocks)]
                orbax_format.commit(f"{play}.tmp", play, orbax_format.layout(blocks[0]),
                                    entries)
                res["played"] = play
            out["failed_write"] = _failed_write(tr, os.path.join(tmp, "fail"))
        del whole
        out[name] = res
    out["fit"] = _orbax_fit(rank, cfg, h5, batch, os.path.join(tmp, "exp"))
    _wait_for(jax_dir)
    out["jax"] = {f"{s[0]}x{s[1]}": _restore_orbax(cfg, tkw, s, jax_dir) for s in ORBAX_MESHES}
    tr = Trainer(cfg, TrainConfig(**tkw), device="cpu",
                 mesh=pmesh.make_mesh(*ORBAX_MESHES[0], device="cpu"))
    tr.init_state(2)
    tr.load_state(ckpt.restore_checkpoint(jax_msgpack))
    out["jax_msgpack"] = _jax_np(tr, 1)
    return out


def _wait_for(path, timeout=600.0):
    """Wait until ``path`` exists (a directory the caller's process writes
    meanwhile, and commits by renaming); a ``FAILED`` file beside it
    raises."""
    import time

    t0 = time.monotonic()
    failed = os.path.join(os.path.dirname(path), "FAILED")
    while not os.path.exists(path):
        if os.path.exists(failed) or time.monotonic() - t0 > timeout:
            raise RuntimeError(f"{path} was not written")
        time.sleep(0.2)


def _failed_write(tr, exp_dir):
    """Rank 2's write of ``tr``'s state raises: every rank's save raises,
    nothing is committed."""
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train import orbax_format

    real = orbax_format.write_shards

    def broken(tmp, r, tree):
        if r == 2:
            raise OSError("disk full")
        return real(tmp, r, tree)

    orbax_format.write_shards = broken
    try:
        ckpt.save_checkpoint_orbax(exp_dir, 1, tr.orbax_state(1), wait=True)
        err = None
    except OSError as e:
        err = str(e)
    finally:
        orbax_format.write_shards = real
    dist.barrier()
    return {"error": err, "committed": os.path.exists(os.path.join(exp_dir, "checkpoint-1.orbax"))}


def _orbax_fit(rank, cfg, h5, batch, exp_root):
    """``fit`` one epoch on the (2, 2) mesh with ZeRO-1 and ``"orbax"`` (the
    all-gathers seen inside its saves), then: the fitted trainer and a
    fresh one restored from the directory take the same step; a third
    trainer resumes the run with ``fit(resume=True)``."""
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer

    mesh = pmesh.make_mesh(2, 2, device="cpu")

    def trainer(epochs, seed=None):
        tr = Trainer(cfg, TrainConfig(epochs=epochs, test_freq=1, exp_name="ofit", batch_size=2,
                                      zero_opt=True), exp_root=exp_root, device="cpu", mesh=mesh)
        if seed is not None:
            tr.init_state(seed)
        return tr

    seen_all = []
    real_save, real_state = ckpt.save_checkpoint_orbax, Trainer.orbax_state

    def spied(fn):
        def call(*a, **k):
            restore, seen = _gather_spy()
            try:
                return fn(*a, **k)
            finally:
                restore()
                seen_all.extend(seen)
        return call

    ckpt.save_checkpoint_orbax = spied(real_save)
    Trainer.orbax_state = spied(real_state)
    try:
        fitted = trainer(1)
        fitted.fit(h5, checkpoint_format="orbax")
        ckpt.wait_for_async_saves()
    finally:
        ckpt.save_checkpoint_orbax, Trainer.orbax_state = real_save, real_state
    exp_dir = os.path.join(exp_root, "ofit")
    path, epoch = ckpt.latest_checkpoint(exp_dir)
    two = {k: v[:2] for k, v in batch.items()}
    want = _train(fitted, two, 1)[0]
    restored = trainer(1, seed=3)
    res = {"epoch": restored.load_orbax_sharded(path), "latest": os.path.basename(path),
           "save_gathers": seen_all}
    res["step_equal"] = _train(restored, two, 1)[0] == want and all(
        torch.equal(a, b) for a, b in zip(restored.model.full_state_dict().values(),
                                          fitted.model.full_state_dict().values()))
    _, exp = trainer(2).fit(h5, resume=True, checkpoint_format="orbax")
    res["loss_history"] = exp.loss_history
    if rank == 0:
        res["listing"] = sorted(os.listdir(exp_dir))
    return res
