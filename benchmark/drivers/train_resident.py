"""Full-width PerformanceNet training from the device-resident store.

The program's ``Trainer`` (fused Adam, the L1 loss, DenseConcat dropout
through the Philox kernel) over ``DeviceDataStore.from_arrays`` of
``chunks`` x the styles, made on the card from the seed: bfloat16 noise
audio (the targets and conditioning are its log-power STFTs, computed
every step) and int8 piano rolls of sparse 20-frame notes with their
onset/offset matrices. Each step is ``train_epoch_resident``'s: the store's
epoch plan, ``store.local_batch`` and ``Trainer.train_step`` with the next
dropout seed; epochs follow one another.

End-to-end: ``train_frames_per_s``, spectrogram frames (batch x 860) of
every step in the window over its seconds.

Correct: the first three steps (set-up) against ``reference/steps.py``
from the same seeded weights and batches (the plan redrawn as the store
draws it, the dropout seeds as the trainer draws them).
"""
from __future__ import annotations

import tempfile

import numpy as np
import torch

from .. import training, traffic_gen, weights
from ..reference import nets, philox
from ..reference import steps as ref_steps
from . import program_config


def make_data(cfg: dict, mix: dict, seed: int, dev) -> dict:
    """{'pianoroll', 'onoff': int8 (N, frames, 128); 'audio_<style>':
    bfloat16 (N, samples)} on ``dev``, from the seed."""
    gen = torch.Generator(device=dev).manual_seed(traffic_gen.sub_seed(seed, "data"))
    n, frames, note = mix["chunks"], cfg["chunk_frames"], mix["note_frames"]
    on = torch.rand((n, -(-frames // note), 128), generator=gen, device=dev) < mix["note_density"]
    roll = on.repeat_interleave(note, dim=1)[:, :frames].to(torch.int8)
    prev = torch.cat([torch.zeros_like(roll[:, :1]), roll[:, :-1]], dim=1)
    raw = {"pianoroll": roll, "onoff": (roll > prev).to(torch.int8) - (roll < prev).to(torch.int8)}
    for style in mix["styles"]:
        a = torch.randn((n, cfg["chunk_samples"]), generator=gen, device=dev, dtype=torch.bfloat16)
        raw[f"audio_{style}"] = a.mul_(mix["audio_scale"])
    return raw


def plan(n: int, batch: int, n_styles: int, seed: int, steps: int) -> list:
    """The first ``steps`` (idx, cond_idx, style) of an epoch, drawn as the
    store draws them: a permutation, then per batch the conditioning rows
    and the styles."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    out = []
    for k in range(steps):
        idx = order[k * batch:(k + 1) * batch]
        out.append((idx, rng.integers(0, n, batch), rng.integers(0, n_styles, batch)))
    return out


def reference_batches(cfg: dict, mix: dict, seed: int, dev) -> list:
    """The reference's batches of the first ``training.CHECK_STEPS`` steps,
    worked out again from the seed: the data, the store's plan and its
    styles in sorted order, each batch's log-power STFTs."""
    raw = make_data(cfg, mix, seed, dev)
    styles = sorted(mix["styles"])
    out = []
    for idx, cond_idx, style in plan(mix["chunks"], int(mix["batch"]), len(styles),
                                     traffic_gen.sub_seed(seed, "plan"), training.CHECK_STEPS):
        audio = [raw[f"audio_{styles[s]}"] for s in style]
        tgt = torch.stack([audio[i][j] for i, j in enumerate(idx)]).float()
        cond = torch.stack([audio[i][j] for i, j in enumerate(cond_idx)]).float()
        ix = torch.from_numpy(idx).to(dev)
        out.append(ref_steps.pnet_batch(tgt, cond, raw["pianoroll"][ix].float(),
                                        raw["onoff"][ix].float(), cfg))
    return out


def run(ctx) -> dict:
    from ml_music_style_transfer_tpu_torch.config import TrainConfig
    from ml_music_style_transfer_tpu_torch.data.device_store import DeviceDataStore
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer
    from ml_music_style_transfer_tpu_torch.utils.profiling import enable_persistent_compile_cache

    cfg, mix = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    enable_persistent_compile_cache(dev)
    batch = int(mix["batch"])
    shapes = nets.performancenet_shapes(cfg)
    w_seed = traffic_gen.sub_seed(ctx.seed, "weights")
    drop_seed = traffic_gen.sub_seed(ctx.seed, "dropout")
    plan_seed = traffic_gen.sub_seed(ctx.seed, "plan")
    tmp = tempfile.TemporaryDirectory(prefix="bench_train_")
    try:
        tc = TrainConfig(batch_size=batch, learning_rate=cfg["learning_rate"], seed=drop_seed)
        trainer = Trainer(program_config.performancenet(cfg), tc, exp_root=tmp.name,
                          device=dev, use_native_loader=False)
        trainer.init_state(seed=0)
        trainer.model.load_state_dict(weights.make(shapes, w_seed, dev), strict=True)
        store = DeviceDataStore.from_arrays(make_data(cfg, mix, ctx.seed, dev), seed=plan_seed,
                                            audio_dtype=torch.bfloat16, device=dev)

        def epochs():
            while True:
                yield from store.draw_epoch_indices(batch)

        feed = epochs()

        def step():
            idx, cond_idx, style = next(feed)
            return trainer.train_step(store.local_batch(idx, cond_idx, style),
                                      trainer.next_dropout_seed())

        prog = training.first_steps(step, list(trainer.model.named_parameters()),
                                    trainer.optimizer, lambda: weights.make(shapes, w_seed, dev),
                                    cfg["adam_b1"])
        win = training.window(ctx, step, dev)
        del trainer, store, feed, step
        peak = training.release(dev)
        loss_rows = ref_steps.pnet_loss_rows(cfg, philox.step_seeds(drop_seed,
                                                                    training.CHECK_STEPS))
        ref = training.reference(cfg, shapes, w_seed, dev,
                                 lambda: reference_batches(cfg, mix, ctx.seed, dev), loss_rows,
                                 int(mix["check_block"]))
        checks = training.judge(prog, ref, mix["limits"])
    finally:
        tmp.cleanup()
    frames = win["steps"] * batch * cfg["chunk_frames"]
    records = {**win, "batch": batch, "prog": prog, "ref": ref}
    return {"attempted": win["steps"], "failed": 0,
            "metrics": {"train_frames_per_s": frames / win["seconds"]},
            "records": records, "checks": checks, "memory_peak_bytes": peak}
