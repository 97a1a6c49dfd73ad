"""The Griffin-Lim glue kernels and the dropout kernel against their plain
versions, on the card.

    python -m ml_music_style_transfer_tpu_torch.scripts.bench_gl_kernels \\
        [--n-iter 300] [--frames 1720] [--batch 16] [--json-out PATH] [--device cuda]

The port's counterpart of the JAX package's ``scripts/bench_gl_pallas.py``:

  - Griffin-Lim (the serving hot path, reference model/inference.py:105-110):
    ``griffinlim_from_log_power`` of a 10 s clip's spectrogram (1720 frames,
    seeded), ``--n-iter`` iterations, with the glue kernels
    (``use_pallas_glue=True``: irfft -> K3a/K3b -> rfft) against without
    them (the istft -> stft loop), in turns, least host-clock time of 3
    each ended by a device sync; and the two waveforms' relative
    difference (the same seeded phase; they differ by float32 rounding,
    which 300 momentum iterations grow);
  - the dropout kernel (K2) at the ten tensors the five DenseConcats hand
    to dropout at full width (``--batch``, bfloat16): its mask and its
    fused apply against the plain apply (``dropout_apply_reference``) and
    ``F.dropout``, each the mean over back-to-back calls timed by CUDA
    events behind a spin of the card (so the events see the kernels, not
    the host's launch rate), and the kernel's mask bit-equal to the plain
    mask.

``--device cpu`` checks the script (the wrappers run their plain versions
on CPU tensors; host clock, one call each); its numbers are CPU numbers.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..device import resolve_device
from ..models import temporal_ladder
from ..ops import griffinlim as tgl
from ..ops.kernels import dropout as dk
from .bench_inference import smi_line, sync

SPIN_CYCLES = 100_000_000  # torch.cuda._sleep: about 50 ms at the H100's boost clock
DROPOUT_RATE = 0.2
DROPOUT_SEED = 0x9E3779B97F4A7C15


def dense_concat_shapes(batch: int) -> list[tuple[int, int, int]]:
    """The (B, C, T) tensors the five DenseConcats hand to dropout at full
    width: hidden (1.5 C) and output (C) at C = 4096..256, T = 53..860."""
    cfg = ModelConfig()
    t_enc = temporal_ladder()["encoder"]
    shapes = []
    for i in range(cfg.depth):
        c, t = cfg.midi_channel_plan[-(i + 1)], t_enc[-(i + 1)]
        shapes += [(batch, int(c * 1.5), t), (batch, c, t)]
    return shapes


def call_ms(fn, dev: torch.device, n: int = 50, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``n`` back-to-back calls: CUDA
    events with the calls queued behind a spin of the card; on the CPU the
    host clock over one call."""
    for _ in range(warmup if dev.type == "cuda" else 0):
        fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3
    sync(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bench_gl(frames: int, n_iter: int, dev: torch.device) -> dict:
    spec = torch.rand((1025, frames), generator=torch.Generator().manual_seed(1)) * 8
    spec = spec.to(dev)

    def run(glue: bool) -> torch.Tensor:
        with torch.inference_mode():
            out = tgl.griffinlim_from_log_power(spec, n_iter=n_iter, use_pallas_glue=glue,
                                                device=dev)
        sync(dev)
        return out

    waves = {g: run(g) for g in (False, True)}  # warm-up, and the waveforms compared
    times = {False: [], True: []}
    for _ in range(3):
        for g in (False, True):
            t = time.perf_counter()
            run(g)
            times[g].append(time.perf_counter() - t)
    plain, glue = min(times[False]), min(times[True])
    rel = float(torch.linalg.vector_norm(waves[True] - waves[False])
                / torch.linalg.vector_norm(waves[False]).clamp(min=1e-9))
    print(f"GL {n_iter} iterations at {frames} frames: istft/stft loop {plain:.4f} s | "
          f"glue kernels {glue:.4f} s | {plain / glue:.2f}x; waveforms' relative "
          f"difference {rel:.2e}", flush=True)
    return {"frames": frames, "n_iter": n_iter, "plain_loop_s": plain, "glue_s": glue,
            "plain_over_glue": plain / glue, "waveform_rel_diff": rel}


def bench_dropout(batch: int, dev: torch.device) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for ci, shape in enumerate(dense_concat_shapes(batch)):
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        mask = dk.dropout_mask(DROPOUT_SEED, ci, shape, DROPOUT_RATE, torch.bfloat16, dev)
        same = torch.equal(mask, dk.dropout_mask_reference(DROPOUT_SEED, ci, shape, DROPOUT_RATE,
                                                           torch.bfloat16, dev))
        row = {"shape": list(shape), "mask_bit_equal_to_plain": same,
               "mask_ms": call_ms(lambda: dk.dropout_mask(DROPOUT_SEED, ci, shape, DROPOUT_RATE,
                                                          torch.bfloat16, dev), dev),
               "apply_ms": call_ms(lambda: dk.dropout_apply(x, DROPOUT_SEED, ci, DROPOUT_RATE),
                                   dev),
               "plain_apply_ms": call_ms(lambda: dk.dropout_apply_reference(
                   x, DROPOUT_SEED, ci, DROPOUT_RATE), dev, n=10),
               "f_dropout_ms": call_ms(lambda: F.dropout(x, DROPOUT_RATE, training=True), dev)}
        print(f"dropout {shape} bf16: mask {row['mask_ms'] * 1e3:.2f} us, apply "
              f"{row['apply_ms'] * 1e3:.2f} us, plain apply {row['plain_apply_ms'] * 1e3:.2f} "
              f"us, F.dropout {row['f_dropout_ms'] * 1e3:.2f} us; mask bit-equal to plain: "
              f"{same}", flush=True)
        if not same:
            raise RuntimeError(f"the dropout kernel's mask differs from the plain one at {shape}")
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n-iter", type=int, default=300)
    ap.add_argument("--frames", type=int, default=1720,
                    help="Griffin-Lim frames (1720: a 10 s clip rounded up to half a chunk)")
    ap.add_argument("--batch", type=int, default=16, help="batch of the dropout tensors")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = smi_line() if dev.type == "cuda" else "cpu"
    print(where, flush=True)
    results = {"device": where, "torch": torch.__version__,
               "griffinlim": bench_gl(args.frames, args.n_iter, dev),
               "dropout": bench_dropout(args.batch, dev)}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
