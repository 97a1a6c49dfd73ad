"""The spectrogram autoencoder's spectral-loss training step.

``make_autoencoder_train_step(model).step`` (mel projection, multi-scale mel
spectral loss at the configuration's band scales, fused Adam) on batches of
(batch, 860, 1025) log-power frames gathered on the card each step at rows
drawn from the seed (a permutation of the pool per epoch, so no two steps
of an epoch share a row) from a pool of ``pool_batches`` batches made on
the card at set-up: log1p of exponentially distributed power, as noise's
|STFT|^2 is.

End-to-end: ``train_frames_per_s``, frames (batch x 860) of every step in
the window over its seconds.

Correct: the first three steps (set-up) against ``reference/steps.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import training, traffic_gen, weights
from ..reference import dsp, nets
from ..reference import steps as ref_steps
from . import program_config


def make_pool(cfg: dict, mix: dict, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(traffic_gen.sub_seed(seed, "data"))
    shape = (int(mix["pool_batches"]) * int(mix["batch"]), cfg["frames"], cfg["n_fft"] // 2 + 1)
    u = torch.rand(shape, generator=gen, device=dev)
    return torch.log1p(torch.log1p(-u).mul_(-float(mix["mean_power"])))


def rows(n: int, batch: int, seed: int):
    """Batches of pool rows: each epoch a fresh permutation of the pool."""
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for k in range(n // batch):
            yield perm[k * batch:(k + 1) * batch]


def reference_batches(cfg: dict, mix: dict, seed: int, dev) -> list:
    """The reference's batches of the first ``training.CHECK_STEPS`` steps,
    gathered again from the pool made anew from the seed."""
    pool = make_pool(cfg, mix, seed, dev)
    it = rows(pool.shape[0], int(mix["batch"]), traffic_gen.sub_seed(seed, "plan"))
    return [{"spec": pool[torch.from_numpy(next(it)).to(dev)]}
            for _ in range(training.CHECK_STEPS)]


def run(ctx) -> dict:
    from ml_music_style_transfer_tpu_torch.models.autoencoder import (
        SpectrogramAutoencoder, make_autoencoder_train_step)

    cfg, mix = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    batch = int(mix["batch"])
    shapes = nets.autoencoder_shapes(cfg)
    w_seed = traffic_gen.sub_seed(ctx.seed, "weights")
    plan_seed = traffic_gen.sub_seed(ctx.seed, "plan")
    model = SpectrogramAutoencoder(program_config.autoencoder(cfg), device=dev)
    model.load_state_dict(weights.make(shapes, w_seed, dev), strict=True)
    trainer = make_autoencoder_train_step(model, sr=cfg["sr"], n_fft=cfg["n_fft"],
                                          learning_rate=cfg["learning_rate"],
                                          band_scales=tuple(cfg["band_scales"]))
    pool = make_pool(cfg, mix, ctx.seed, dev)
    feed = rows(pool.shape[0], batch, plan_seed)
    weight = torch.ones(batch, device=dev)

    def step():
        idx = torch.from_numpy(next(feed))
        if dev.type == "cuda":
            idx = idx.pin_memory().to(dev, non_blocking=True)
        return trainer.step(pool.index_select(0, idx), weight)

    prog = training.first_steps(step, list(model.named_parameters()), trainer.optimizer,
                                lambda: weights.make(shapes, w_seed, dev), cfg["adam_b1"])
    win = training.window(ctx, step, dev)
    del model, trainer, pool, feed, step
    peak = training.release(dev)
    bank = torch.from_numpy(dsp.mel_bank(cfg["sr"], cfg["n_fft"], cfg["n_bins"])).to(dev)
    ref = training.reference(cfg, shapes, w_seed, dev,
                             lambda: reference_batches(cfg, mix, ctx.seed, dev),
                             ref_steps.ae_loss_rows(cfg, bank), int(mix["check_block"]))
    checks = training.judge(prog, ref, mix["limits"])
    frames = win["steps"] * batch * cfg["frames"]
    records = {**win, "batch": batch, "prog": prog, "ref": ref}
    return {"attempted": win["steps"], "failed": 0,
            "metrics": {"train_frames_per_s": frames / win["seconds"]},
            "records": records, "checks": checks, "memory_peak_bytes": peak}
