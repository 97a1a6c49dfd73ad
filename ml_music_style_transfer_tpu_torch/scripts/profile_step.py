"""Ablation profile of the train step: the counterpart of the root
``scripts/profile_step.py``.

At a batch size, width and clip length (default 16, full width and 860
frames; bf16 compute on the card, float32 on the CPU, where bf16 convs
are slow and only the script is checked) it times:
  - the forward (eval mode, no autograd), the forward + backward of the L1
    loss, and the full update (``Trainer.train_step``: train-mode forward
    with the dropout kernel, backward, fused Adam);
  - the forward of each subsystem alone, each a reduced model fed what the
    model before it computes: the encoders (the MIDI, audio and onset
    encoders' DownConvs), the five DenseConcat fusions, the decoder's four
    UpConvs, and the four MBR blocks with the head.

On the card every time is the mean of ``--n-iter`` calls between CUDA
events after ``--warmup`` calls (queued behind a spin of the card, as
``chip_smoke.cuda_ms`` times kernels); on the CPU (``--device cpu``, which
checks the script) the host clock stands in. It prints the card's name and
power limit first, one ``metric`` line per time, then one JSON object.

    python -m ml_music_style_transfer_tpu_torch.scripts.profile_step \
        [--batch-size 16] [--width-mult 1.0] [--frames 860] [--n-iter 10] [--warmup 3]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..device import resolve_device
from ..train import losses
from ..train.loop import Trainer
from .bench_inference import metric_line, smi_line



SPIN_CYCLES = 100_000_000  # about 50 ms at the H100's 1.98 GHz boost clock


def mean_ms(fn, device: torch.device, n_iter: int, warmup: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n_iter`` calls after ``warmup``:
    between CUDA events on the card, by the host clock on the CPU. The card
    first spins about 50 ms while the host queues the calls, so work that
    launches faster than the card runs it is timed back to back, not at
    the host's launch rate."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        return (time.perf_counter() - t0) / n_iter * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def inputs(batch: int, frames: int, device: torch.device, seed: int = 0) -> dict:
    """A seeded batch in the model's layout, on ``device``."""
    rng = np.random.default_rng(seed)
    arrays = {
        "midi": (rng.random((batch, frames, 128)) < 0.05).astype(np.float32),
        "onoff": rng.choice([-1.0, 0.0, 1.0], (batch, frames, 128), p=[0.02, 0.96, 0.02]),
        "cond": rng.random((batch, frames, 1025)),
        "target": rng.random((batch, frames, 1025)),
        "weight": np.ones(batch),
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in arrays.items()}


def subsystems(model, b: dict) -> dict:
    """{name: zero-argument forward of that subsystem alone} on the inputs
    the model's earlier subsystems give it (computed once, here)."""
    midi, audio, cond = (b[k].transpose(1, 2) for k in ("midi", "cond", "onoff"))

    def encoders():
        h, a, skips_h, skips_a = midi, audio, [], []
        for down in model.down_convs:
            h, before = down(h)
            skips_h.append(before)
        for down in model.down_convs_audio:
            a, before = down(a)
            skips_a.append(before)
        return h, a, skips_h, skips_a, model.onset_offset_encoder(cond)

    h, a, skips_h, skips_a, onoff = encoders()

    def fusions():
        out = [model.dense_concats[0](h, a, True, None, 0)]
        for i in range(1, len(model.dense_concats)):
            out.append(model.dense_concats[i](skips_h[-(i + 1)], skips_a[-(i + 1)],
                                              True, None, 2 * i))
        return out

    fused = fusions()

    def decoder():
        x = fused[0]
        for i, up in enumerate(model.up_convs):
            x = up(fused[i + 1], x, onoff[i - 1] if up.has_condition else None)
        return x

    decoded = decoder()

    def mbr_and_head():
        x = decoded
        for j in range(1, 5):
            x = getattr(model, f"MBRBlock{j}")(x)
        return model.lastconv.full(model.lastconv(x))

    return {"encoders": encoders, "dense_fusions": fusions, "decoder": decoder,
            "mbr_and_head": mbr_and_head}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=860,
                    help="clip length in STFT frames (860: one training chunk)")
    ap.add_argument("--n-iter", type=int, default=10, help="timed calls per measurement")
    ap.add_argument("--warmup", type=int, default=3, help="untimed calls first")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(smi_line(), flush=True)
    bs = args.batch_size
    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    tr = Trainer(ModelConfig(width_mult=args.width_mult, compute_dtype=dtype),
                 TrainConfig(batch_size=bs), device=dev)
    model, _ = tr.init_state(0)
    b = inputs(bs, args.frames, dev)
    extra = dict(batch=bs, width_mult=args.width_mult, t=args.frames, dtype=dtype,
                 n_iter=args.n_iter,
                 params=sum(p.numel() for p in model.parameters()))
    metrics = {}

    def report(name, ms, **more):
        metrics[name] = ms
        print(metric_line(name, ms, "ms", dev, **extra, **more), flush=True)

    def timed(fn):
        return mean_ms(fn, dev, args.n_iter, args.warmup)

    def forward():
        return model(b["midi"], b["cond"], b["onoff"], deterministic=True)

    def forward_backward():
        model.zero_grad(set_to_none=True)
        losses.l1_loss(forward(), b["target"], b["weight"]).backward()

    with torch.no_grad():
        report("forward_ms", timed(forward))
    report("forward_backward_ms", timed(forward_backward))
    seeds = iter(range(1 << 30))
    report("full_update_ms", timed(lambda: tr.train_step(b, next(seeds))))
    with torch.no_grad():
        parts = {name: timed(fn) for name, fn in subsystems(model, b).items()}
    total = sum(parts.values())
    for name, ms in parts.items():
        report(f"forward_{name}_ms", ms, share_of_parts=round(ms / total, 4))
    print(json.dumps({"metrics": metrics, "device": str(dev),
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}))
    return metrics


if __name__ == "__main__":
    main()
