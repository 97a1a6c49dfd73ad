"""Spectrogram Diffusion's training step at its published widths.

``make_spectrogram_diffusion_train_step(model).step`` on batches of
``batch`` segments, each its note tokens and its context and target audio.
A pool of ``pool_batches`` batches is made at set-up from the seed:

  - notes: each segment's count is a quantile of the lognormal (median,
    sigma, clipped), the quantiles shuffled over the pool, so every seed
    holds the same counts; pitches uniform over ``pitches``, onsets uniform
    over ``[-onset_lead_s, segment)`` (a note begun before the segment
    lands in its tie section), durations lognormal, velocities 1-127; the
    segment encoded by the program's ``midi/events.py`` and kept on the host;
  - audio: noise rows on the card, each a context segment and a target
    segment of ``(targets_length - 1) x hop`` samples (256 frames).

Each step takes the rows of the next batch of a fresh permutation of the
pool per epoch and the next 64-bit seed of a host generator; the program
computes the log-mel of both segments, draws the noise step and the noise
from that seed and drops out through K2 with it.

End-to-end: ``train_frames_per_s``, target frames (batch x targets_length)
of every step in the window over its seconds.

Correct: the first three steps (set-up) against ``reference/t5film.py``
through ``reference/steps.py``, from the same seeded weights
(``t5_weights.py``), batches and seeds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import t5_weights, training, traffic_gen
from ..reference import nets, philox, t5film
from ..reference import steps as ref_steps
from .train_autoencoder import rows


def program_config(cfg: dict):
    """The program's configuration from the file's keys, every field named
    there (a run is of the configuration it names)."""
    from ml_music_style_transfer_tpu_torch.models.spectrogram_diffusion import (
        SpectrogramDiffusionConfig)

    return SpectrogramDiffusionConfig(**{f.name: cfg[f.name]
                                         for f in dataclasses.fields(SpectrogramDiffusionConfig)})


def segment_seconds(cfg: dict) -> float:
    return cfg["targets_length"] * cfg["hop"] / cfg["sr"]


def make_notes(cfg: dict, mix: dict, seed: int) -> list:
    """The pool's note lists, one a segment."""
    from ml_music_style_transfer_tpu_torch.midi import Note

    n = int(mix["pool_batches"]) * int(mix["batch"])
    spec = mix["notes"]
    counts = traffic_gen.lognormal_quantiles(n, spec["median"], spec["sigma"], spec["min"],
                                             spec["max"])
    rng = np.random.default_rng(traffic_gen.sub_seed(seed, "notes"))
    counts = [int(round(c)) for c in rng.permutation(counts)]
    seg, dur = segment_seconds(cfg), mix["durations"]
    lo, hi = mix["pitches"]
    out = []
    for c in counts:
        start = rng.uniform(-mix["onset_lead_s"], seg, c)
        length = np.clip(dur["median_s"] * np.exp(dur["sigma"] * rng.standard_normal(c)),
                         dur["min_s"], dur["max_s"])
        out.append([Note(int(p), int(v), float(s), float(s + d)) for p, v, s, d in
                    zip(rng.integers(lo, hi + 1, c), rng.integers(1, 128, c), start, length)])
    return out


def make_tokens(cfg: dict, mix: dict, seed: int) -> torch.Tensor:
    """(pool rows, max_length) int64 tokens on the host."""
    from ml_music_style_transfer_tpu_torch.midi import events

    seg = segment_seconds(cfg)
    return torch.from_numpy(np.stack([events.encode_segment(notes, 0.0, seg, cfg["max_length"])
                                      for notes in make_notes(cfg, mix, seed)]))


def make_audio(cfg: dict, mix: dict, seed: int, dev) -> torch.Tensor:
    """(pool rows, 2, samples) float32 noise on ``dev``: context, target."""
    gen = torch.Generator(device=dev).manual_seed(traffic_gen.sub_seed(seed, "audio"))
    n = int(mix["pool_batches"]) * int(mix["batch"])
    samples = (cfg["targets_length"] - 1) * cfg["hop"]
    return torch.randn((n, 2, samples), generator=gen, device=dev).mul_(float(mix["audio_scale"]))


def step_seeds(seed: int):
    """The steps' 64-bit seeds, as ``philox.step_seeds`` draws them."""
    gen = torch.Generator().manual_seed(seed)
    while True:
        lo, hi = torch.randint(0, 2**32, (2,), generator=gen).tolist()
        yield lo | (hi << 32)


def reference_batches(cfg: dict, mix: dict, seed: int, dev) -> list:
    """The first ``training.CHECK_STEPS`` steps' batches, made again from
    the seed: the pool, the rows, the step seeds; the features and noise by
    the reference."""
    tokens, audio = make_tokens(cfg, mix, seed), make_audio(cfg, mix, seed, dev)
    feed = rows(tokens.shape[0], int(mix["batch"]), traffic_gen.sub_seed(seed, "plan"))
    seeds = philox.step_seeds(traffic_gen.sub_seed(seed, "dropout"), training.CHECK_STEPS)
    out = []
    for s in seeds:
        ix = torch.from_numpy(next(feed))
        out.append(t5film.batch(tokens[ix].to(dev), audio[ix.to(dev)], s, cfg))
    return out


def reference(cfg: dict, mix: dict, seed: int, dev, quant=nets.identity, fault=None) -> dict:
    """The reference's three steps, TF32 off; ``fault`` wraps its rows'
    loss (``control.KINDS``)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params0 = t5_weights.make(cfg, traffic_gen.sub_seed(seed, "weights"), dev)
        seeds = philox.step_seeds(traffic_gen.sub_seed(seed, "dropout"), training.CHECK_STEPS)
        loss_rows = t5film.loss_rows(cfg, seeds, quant)
        if fault is not None:
            loss_rows = fault(loss_rows)
        opt = {"lr": cfg["learning_rate"], "b1": cfg["adam_b1"], "b2": cfg["adam_b2"],
               "eps": cfg["adam_eps"]}
        return ref_steps.train(params0, reference_batches(cfg, mix, seed, dev), loss_rows, opt,
                               int(mix["check_block"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def run(ctx) -> dict:
    from ml_music_style_transfer_tpu_torch.models.spectrogram_diffusion import (
        SpectrogramDiffusion, make_spectrogram_diffusion_train_step)
    from ml_music_style_transfer_tpu_torch.utils.profiling import enable_persistent_compile_cache

    cfg, mix = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    enable_persistent_compile_cache(dev)
    batch = int(mix["batch"])
    w_seed = traffic_gen.sub_seed(ctx.seed, "weights")
    model = SpectrogramDiffusion(program_config(cfg), device=dev)
    model.load_state_dict(t5_weights.make(cfg, w_seed, dev), strict=True)
    trainer = make_spectrogram_diffusion_train_step(model, learning_rate=cfg["learning_rate"])
    tokens, audio = make_tokens(cfg, mix, ctx.seed), make_audio(cfg, mix, ctx.seed, dev)
    feed = rows(tokens.shape[0], batch, traffic_gen.sub_seed(ctx.seed, "plan"))
    seeds = step_seeds(traffic_gen.sub_seed(ctx.seed, "dropout"))
    real = []  # each step's note tokens, counted from the traffic

    def step():
        ix = torch.from_numpy(next(feed))
        tok = tokens[ix]
        real.append(int(torch.count_nonzero(tok)))
        rows_dev = ix.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else ix
        return trainer.step(tok, audio.index_select(0, rows_dev), next(seeds))

    prog = training.first_steps(step, list(model.named_parameters()), trainer.optimizer,
                                lambda: t5_weights.make(cfg, w_seed, dev), cfg["adam_b1"])
    win = training.window(ctx, step, dev)
    positions = tokens.shape[1] * batch
    del model, trainer, audio, feed, step
    peak = training.release(dev)
    ref = reference(cfg, mix, ctx.seed, dev)
    checks = training.judge(prog, ref, mix["limits"])
    frames = win["steps"] * batch * cfg["targets_length"]
    records = {**win, "batch": batch, "prog": prog, "ref": ref,
               "notes_tokens": real[training.CHECK_STEPS:], "notes_positions": positions}
    return {"attempted": win["steps"], "failed": 0,
            "metrics": {"train_frames_per_s": frames / win["seconds"]},
            "records": records, "checks": checks, "memory_peak_bytes": peak}
