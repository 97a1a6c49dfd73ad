"""Benchmark the train step on the card: the port's counterpart of the JAX
package's ``bench.py`` headline.

    python -m ml_music_style_transfer_tpu_torch.scripts.bench_train \\
        [--data host|resident] [--batch-size 16] [--epochs 3] \\
        [--width-mult 1.0] [--device cuda]

A full train step (forward in training mode with DenseConcat dropout,
L1, backward, fused Adam with float32 moments) of a PerformanceNet
(full width, 731,945,857 params, bfloat16 compute, seeded random weights)
on seeded synthetic chunks, fed one of two ways:

  - ``--data host``: ``Trainer.train_epoch`` over a ``ChunkDataset`` of
    spectrograms in host memory, batches from the native assembler staged
    to the card each step;
  - ``--data resident``: ``Trainer.train_epoch_resident`` over a
    ``DeviceDataStore`` of bfloat16 audio made on the card; each step
    gathers and STFTs its batch there.

Epochs of four steps; one warm-up epoch, then ``--epochs`` timed epochs,
each on the host clock and ended by reading its losses back. It prints the
card's name and power limit (``nvidia-smi``), then one ``metric`` line per
number, under ``bench.py``'s names:

  - ``train_step_spectrogram_frames_per_sec_per_chip``: batch x 860 frames
    over the median step seconds (``train_step_s``);
  - ``train_step_device_busy_share``: device time of one profiled epoch
    (torch.profiler, kernels and copies) over the unprofiled step time;
  - ``preprocess_frames_per_sec``: 32 chunks of 219,904 samples through
    ``preprocess.spectrograms_from_chunks(backend="device")``, 860 frames
    each, upload and download included (best of 3).

``bench.py``'s default bfloat16-moment Adam waits for the port's optimizer
options (ROADMAP queue 1 item 7): this bench runs the Trainer's
float32-moment Adam. ``--device cpu`` runs it at width 1/16 to check the
script; its numbers are CPU numbers and no busy share is measured.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..data import preprocess
from ..data.dataset import ChunkDataset
from ..data.device_store import DeviceDataStore
from ..device import resolve_device
from ..train.loop import Trainer
from .bench_inference import metric_line, smi_line, sync

STEPS_PER_EPOCH = 4
STYLES = ("gentleman", "harpsichord")
PREPROCESS_CHUNKS = 32


def host_arrays(n: int, seed: int, styles=STYLES) -> dict:
    """Seeded preprocessed-dataset arrays in host memory: rolls in {0, 1},
    onoff in {-1, 0, 1}, log-power spectrograms uniform in [0, 8]."""
    rng = np.random.default_rng(seed)
    raw = {"pianoroll": (rng.random((n, 860, 128), dtype=np.float32) < 0.05).astype(np.float32),
           "onoff": rng.integers(-1, 2, (n, 860, 128)).astype(np.float32)}
    for s in styles:
        raw[f"spec_{s}"] = rng.random((n, 1025, 860), dtype=np.float32) * 8.0
    return raw


def device_arrays(n: int, seed: int, device: torch.device, styles=STYLES,
                  n_samples: int = 219904) -> dict:
    """The same for a device store, made on ``device`` from a seed: audio
    N(0, 0.05^2) per style (float32), rolls and onoff as above."""
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = {"pianoroll": (torch.rand((n, 860, 128), generator=gen, device=device) < 0.05).float(),
           "onoff": torch.randint(-1, 2, (n, 860, 128), generator=gen, device=device).float()}
    for s in styles:
        raw[f"audio_{s}"] = 0.05 * torch.randn((n, n_samples), generator=gen, device=device)
    return raw


def epoch_step_seconds(run_epoch, n_steps: int, device: torch.device, epochs: int) -> list[float]:
    """Seconds per step of each of ``epochs`` calls of ``run_epoch`` (one
    epoch of ``n_steps`` steps that reads its losses back), host clock."""
    out = []
    for _ in range(epochs):
        sync(device)
        t = time.perf_counter()
        run_epoch()
        sync(device)
        out.append((time.perf_counter() - t) / n_steps)
    return out


def device_ms_per_step(run_epoch, n_steps: int) -> float:
    """Device time per step under torch.profiler: kernels and copies, not
    the annotations that mirror host ranges onto the device's timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_epoch()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if (e.device_type == DeviceType.CUDA and t > 0
                and not getattr(e, "is_user_annotation", False) and "#" not in e.key):
            us += t
    return us / 1e3 / n_steps


def preprocess_frames_per_sec(device: torch.device, seed: int = 0) -> float:
    """860 frames per chunk over the best of 3 calls of
    ``spectrograms_from_chunks`` on 32 seeded chunks (``backend="device"``)."""
    chunks = np.random.default_rng(seed).standard_normal(
        (PREPROCESS_CHUNKS, 219904)).astype(np.float32)
    run = lambda: preprocess.spectrograms_from_chunks(chunks, backend="device", device=device)  # noqa: E731
    run()
    times = []
    for _ in range(3):
        sync(device)
        t = time.perf_counter()
        run()
        sync(device)
        times.append(time.perf_counter() - t)
    return PREPROCESS_CHUNKS * 860 / min(times)


def make_epoch(tr: Trainer, data: str, batch_size: int, device: torch.device, seed: int = 1):
    """A callable running one epoch of ``STEPS_PER_EPOCH`` steps on seeded
    synthetic data fed as ``data`` ('host' or 'resident')."""
    n = batch_size * STEPS_PER_EPOCH
    if data == "host":
        ds = ChunkDataset.from_arrays(host_arrays(n, seed), seed=seed)
        return lambda: tr.train_epoch(ds, 0, log_every=10**9)
    if data == "resident":
        store = DeviceDataStore.from_arrays(device_arrays(n, seed, device), seed=seed,
                                            device=device)
        return lambda: tr.train_epoch_resident(store, 0)
    raise ValueError(f"--data must be 'host' or 'resident', got {data!r}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", choices=("host", "resident"), default="host")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=3,
                    help=f"timed epochs of {STEPS_PER_EPOCH} steps after one warm-up epoch")
    ap.add_argument("--width-mult", type=float, default=None,
                    help="channel-width multiplier (default 1.0 on the card, 1/16 on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    width = args.width_mult if args.width_mult is not None else (
        1.0 if dev.type == "cuda" else 1 / 16)
    if dev.type == "cuda":
        print(smi_line(), flush=True)
    metrics = {}

    def report(name, value, unit, **extra):
        metrics[name] = value
        print(metric_line(name, value, unit, dev, **extra), flush=True)

    bs = args.batch_size
    tr = Trainer(ModelConfig(width_mult=width), TrainConfig(batch_size=bs, seed=0), device=dev)
    tr.init_state(0)
    n_params = sum(p.numel() for p in tr.model.parameters())
    run_epoch = make_epoch(tr, args.data, bs, dev)
    run_epoch()  # warm-up
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    per_step = epoch_step_seconds(run_epoch, STEPS_PER_EPOCH, dev, args.epochs)
    step_s = statistics.median(per_step)
    extra = dict(data=args.data, batch=bs, width_mult=width, params=n_params,
                 steps=STEPS_PER_EPOCH * args.epochs)
    report("train_step_spectrogram_frames_per_sec_per_chip", bs * 860 / step_s, "frames/s",
           **extra)
    report("train_step_s", step_s, "s", epochs_s_per_step=[round(x, 5) for x in per_step],
           **extra)
    if dev.type == "cuda":
        report("train_step_peak_memory_GB", torch.cuda.max_memory_allocated(dev) / 1e9, "GB",
               **extra)
        dev_ms = device_ms_per_step(run_epoch, STEPS_PER_EPOCH)
        report("train_step_device_busy_share", dev_ms / (step_s * 1e3), "",
               device_ms_per_step=round(dev_ms, 3), **extra)
    report("preprocess_frames_per_sec", preprocess_frames_per_sec(dev), "frames/s",
           chunks=PREPROCESS_CHUNKS, backend="device")
    print(json.dumps({"metrics": metrics, "device": str(dev),
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}))
    return metrics


if __name__ == "__main__":
    main()
