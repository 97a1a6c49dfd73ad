"""Process-group launching: ``spawn`` (a function on n ranks of a fresh
group, for tests and scripts) and ``dryrun_multichip``, the port's
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.

``spawn`` joins its ranks through a ``file://`` store in a new temporary
directory (never a fixed TCP port, so concurrent launches on one machine
cannot collide). Under ``torchrun`` a script calls
``parallel/mesh.distributed_init`` instead.

    python -m ml_music_style_transfer_tpu_torch.parallel.launch N [--device cpu]

runs the dry run on N ranks: one card each with NCCL (the default; fewer
cards than N raises), or N gloo processes on the CPU with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import pickle
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as pmesh


def _entry(rank: int, fn, world_size: int, device: str, tmp: str, timeout: float) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    pmesh.distributed_init(device, init_method=f"file://{tmp}/store", world_size=world_size,
                           rank=rank, timeout=timeout)
    try:
        out = fn(rank, *args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), device: str = "cuda",
          timeout: float = 300.0) -> list:
    """``fn(rank, *args)`` on ``world_size`` new processes joined in one
    process group (NCCL on one card each, or gloo with ``device="cpu"``),
    each with one intra-op thread. ``fn`` must be importable (a module's
    top-level function). ``args`` reach the ranks through a file: through
    the start pipe, a large one would hold each rank's start until the rank
    before had imported torch. Returns the ranks' return values, in rank
    order; raises if any rank fails, or waits in a collective for more
    than ``timeout`` seconds (so ranks that fall out of step fail the
    call)."""
    if device == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards, "
                           f"{torch.cuda.device_count()} visible")
    tmp = tempfile.mkdtemp(prefix="mmst_spawn_")
    try:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        mp.spawn(_entry, args=(fn, world_size, device, tmp, timeout), nprocs=world_size,
                 join=True)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the dry run --------------------------------------------------------------

def _batch(rng, b: int, t: int) -> dict:
    return {
        "midi": (rng.random((b, t, 128)) < 0.05).astype(np.float32),
        "onoff": rng.choice([-1.0, 0.0, 1.0], (b, t, 128), p=[0.02, 0.96, 0.02]).astype(
            np.float32),
        "cond": rng.random((b, t, 1025)).astype(np.float32),
        "target": rng.random((b, t, 1025)).astype(np.float32),
        "weight": np.ones((b,), np.float32),
    }


def _dryrun_rank(rank: int, n: int, device: str) -> list[str]:
    """Every sharded path once on n ranks at width 1/16; returns the OK
    lines (each rank computes them; rank 0's are printed)."""
    from ..config import ModelConfig, TrainConfig
    from ..data.device_store import DeviceDataStore
    from ..models import PerformanceNet
    from ..train.loop import Trainer, stage_batch
    from . import gl_shard, time_shard

    lines = []
    cfg = ModelConfig(width_mult=1 / 16, compute_dtype="float32")
    bs = max(8, n)
    shape = (n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1)
    mesh = pmesh.make_mesh(*shape, device=device)
    rng = np.random.default_rng(0)
    t = 220  # a valid decoder ladder: 220 -> ... -> 13 -> ... -> 220
    host = _batch(rng, bs, t)

    def step(tr):
        batch = stage_batch(tr.shard_batch(host), tr.device)
        loss = float(tr.train_step(batch, 0))
        assert np.isfinite(loss), loss
        return loss

    tr = Trainer(cfg, TrainConfig(batch_size=bs), device=device, mesh=mesh)
    tr.init_state(0)
    lines.append(f"dryrun_multichip OK: mesh={pmesh.mesh_shape(mesh)} devices={n} "
                 f"loss={step(tr):.4f}")

    tz = Trainer(cfg, TrainConfig(batch_size=bs, zero_opt=True), device=device, mesh=mesh)
    tz.init_state(0)
    zloss = step(tz)
    mine = pmesh.per_rank_bytes(tz.optimizer.inner.state[s][k]
                                for s in tz.optimizer.shards for k in ("exp_avg", "exp_avg_sq"))
    whole = 2 * pmesh.per_rank_bytes(tz.model.parameters())
    assert mine < whole, (mine, whole)
    lines.append(f"dryrun_multichip ZeRO-1 OK: opt-state bytes/device "
                 f"{mine / whole:.2f}x of total, loss={zloss:.4f}")

    n_store = max(bs, 8)
    raw = {"pianoroll": (rng.random((n_store, t, 128)) < 0.05).astype(np.int8),
           "onoff": rng.choice([-1, 0, 1], (n_store, t, 128)).astype(np.int8),
           "audio_a": rng.standard_normal((n_store, (t - 1) * 256)).astype(np.float32),
           "audio_b": rng.standard_normal((n_store, (t - 1) * 256)).astype(np.float32)}
    store = DeviceDataStore.from_arrays(raw, audio_dtype=torch.float32, mesh=mesh)
    idx, cidx, style = next(store.draw_epoch_indices(bs))
    rloss = float(tr.train_step(store.local_batch(idx, cidx, style), 1))
    assert np.isfinite(rloss), rloss
    lines.append(f"dryrun_multichip resident OK: mesh={pmesh.mesh_shape(mesh)} "
                 f"loss={rloss:.4f}")

    tmesh = pmesh.make_axis_mesh(n, "time", device=device)
    t_frames = n * 16
    spec = (rng.random((t_frames, 129)) * 2.0).astype(np.float32)
    wav = gl_shard.sharded_griffinlim_from_log_power(
        spec, tmesh, n_iter=4, hop_length=64, halo=4, rounds=2).cpu().numpy()
    assert np.isfinite(wav).all() and wav.shape == (t_frames * 64,)
    lines.append(f"dryrun_multichip sharded-GL OK: {n}-device time mesh, {t_frames} frames")

    ts_cfg = ModelConfig(start_channels=32, start_audio_channels=65, width_mult=1 / 16,
                         compute_dtype="float32")
    t_valid = max(220, n * 32)
    dev = pmesh.mesh_device(tmesh)
    model = PerformanceNet(ts_cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    tst = time_shard.make_time_sharded_train_step(model, tmesh, t_valid)

    def pad_shard(a, t_to):
        p = np.zeros((1, tst.t_pad, a.shape[-1]), np.float32)
        p[:, :t_to] = a
        return time_shard.shard_time(torch.from_numpy(p).to(dev), tmesh)

    ts_loss = float(tst.step(
        pad_shard(rng.standard_normal((t_valid, 32)), t_valid),
        pad_shard(rng.standard_normal((t_valid, 65)), t_valid),
        pad_shard(rng.random((t_valid, 32)) < 0.05, t_valid),
        pad_shard(rng.standard_normal((tst.t_out, ts_cfg.n_out_bins)), tst.t_out)))
    assert np.isfinite(ts_loss), ts_loss
    lines.append(f"dryrun_multichip time-sharded train OK: {n}-device time mesh, "
                 f"t={t_valid}, loss={ts_loss:.4f}")

    if n % 4 == 0:
        hmesh = pmesh.make_mesh(n // 4, 2, dcn=2, device=device)
        htr = Trainer(cfg, TrainConfig(batch_size=bs), device=device, mesh=hmesh)
        htr.init_state(0)
        lines.append(f"dryrun_multichip hybrid OK: mesh={pmesh.mesh_shape(hmesh)} "
                     f"loss={step(htr):.4f}")
    return lines


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[str]:
    """One step of every sharded path (DP x TP, ZeRO-1, the resident store,
    sharded Griffin-Lim, the time-sharded train step and, where 4 divides
    n, the hybrid dcn mesh) on ``n_devices`` ranks at width 1/16; prints and
    returns rank 0's OK lines."""
    lines = spawn(_dryrun_rank, n_devices, (n_devices, device), device=device)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
