"""The control of ``correct``: the reference put in the program's place,
computed one precision below the configuration's (float8 e4m3 inputs and
weights of every convolution and linear, where the configuration states
bfloat16), and judged by the same numbers against the same limits. It has
to come out not correct.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 [--kind K] [--test]

runs on the card at the cell's own sizes (``--test``: the CPU test hook's
tiny sizes) and prints one JSON line per seed: the control's numbers, their
limits and whether a limit was broken. The benchmark's own runs never run
it. Serving: the sample a run would check (the pool's longest score and
``check_requests`` - 1 more, with timbres drawn from the seed), each
answered by the float8 reference, written to 16-bit as the daemon writes
it. Training: the first three steps of the cell's batches.

``--kind`` reads a training fault instead of the float8 control, planted
in the reference put in the program's place: ``half_batch`` (the loss
over the first half of each batch, its mean over those rows) or
``scaled_loss`` (the loss, and so the gradient, times 1.5). A step that
leaves the weights unchanged reads 1 in ``change_gap`` by construction.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from . import harness, training, traffic_gen, weights
from .drivers import train_autoencoder, train_resident
from .reference import dsp, nets, philox, serving
from .reference import steps as ref_steps

TINY = {
    "performancenet": {"width_mult": 0.0625, "midi_channel_plan": [16, 32, 64, 128, 256],
                       "audio_channel_plan": [96, 128, 192, 256, 384]},
    "autoencoder": {"n_bins": 32, "width": 16},
}
TINY_TRAFFIC = {
    "serve_daemon": {"midi": {"pool": 3, "median_s": 6.0, "sigma": 0.3, "min_s": 5.0,
                              "max_s": 8.0},
                     "timbre": {"pool": 2, "min_s": 3.0, "max_s": 5.0, "rates": [44100, 48000]},
                     "n_iter": 4, "check_requests": 2},
    "train_resident": {"batch": 2, "chunks": 8, "styles": ["cuba", "upright"], "check_block": 2},
    "train_autoencoder": {"batch": 4, "pool_batches": 4, "check_block": 4},
}


def _serving(cfg, mix, seed, dev) -> dict:
    with tempfile.TemporaryDirectory(prefix="bench_control_") as tmp:
        traffic = traffic_gen.ServingTraffic(mix, seed, tmp, cfg["sr"] // cfg["hop"])
        rng = np.random.default_rng(traffic_gen.sub_seed(seed, "check"))
        order = sorted(range(len(traffic.midis)), key=lambda i: -traffic.midis[i]["seconds"])
        picks = order[:1] + list(rng.choice(order[1:], min(len(order) - 1,
                                                           mix["check_requests"] - 1),
                                            replace=False))
        params = weights.make(nets.performancenet_shapes(cfg),
                              traffic_gen.sub_seed(seed, "weights"), dev)
        worst: dict[str, float] = {}
        for i in picks:
            notes = traffic_gen.notes_seconds(traffic.midis[int(i)]["notes"])
            timbre = traffic.timbres[int(rng.integers(len(traffic.timbres)))]["path"]
            ref = serving.waveform(params, cfg, notes, timbre, dev, mix["n_iter"])
            ctl = serving.waveform(params, cfg, notes, timbre, dev, mix["n_iter"], quant=nets.fp8)
            as_wav = (ctl.clamp(-1, 1) * 32767.0).to(torch.int16).float() / 32767.0
            for name, v in serving.gaps(as_wav.cpu().numpy(), ref, cfg["n_fft"],
                                        cfg["hop"]).items():
                worst[name] = max(worst.get(name, 0.0), v)
        return worst


def _half_batch(loss_rows):
    """The loss over the first half of each batch only, its mean over them."""
    def rows(params, batch, r0, r1, t):
        half = next(iter(batch.values())).shape[0] // 2
        if r0 >= half:  # a block wholly in the left-out half adds nothing
            return 0.0 * next(iter(params.values())).sum()
        return 2.0 * loss_rows(params, batch, r0, min(r1, half), t)
    return rows


def _scaled(loss_rows):
    return lambda *a: 1.5 * loss_rows(*a)


KINDS = {"fp8": None, "half_batch": _half_batch, "scaled_loss": _scaled}


def _training(driver: str, cfg, mix, seed, dev, kind: str = "fp8") -> dict:
    w_seed = traffic_gen.sub_seed(seed, "weights")
    if driver == "train_resident":
        shapes = nets.performancenet_shapes(cfg)
        batches = train_resident.reference_batches(cfg, mix, seed, dev)
        seeds = philox.step_seeds(traffic_gen.sub_seed(seed, "dropout"), training.CHECK_STEPS)

        def rows(quant):
            return ref_steps.pnet_loss_rows(cfg, seeds, quant)
    else:
        shapes = nets.autoencoder_shapes(cfg)
        batches = train_autoencoder.reference_batches(cfg, mix, seed, dev)
        bank = torch.from_numpy(dsp.mel_bank(cfg["sr"], cfg["n_fft"], cfg["n_bins"])).to(dev)

        def rows(quant):
            return ref_steps.ae_loss_rows(cfg, bank, quant)

    opt = {"lr": cfg["learning_rate"], "b1": cfg["adam_b1"], "b2": cfg["adam_b2"],
           "eps": cfg["adam_eps"]}
    block = int(mix["check_block"])
    params0 = weights.make(shapes, w_seed, dev)
    ref = ref_steps.train(params0, batches, rows(nets.identity), opt, block)
    fault = rows(nets.fp8) if kind == "fp8" else KINDS[kind](rows(nets.identity))
    return ref_steps.step_gaps(ref_steps.train(params0, batches, fault, opt, block), ref)


def readings(workload: str, seed: int, test: bool = False, kind: str = "fp8") -> dict:
    """The control's (or a fault's) numbers for one seed, each with its limit."""
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell, _, cfg = harness.find_cell(spec, workload)
    mix = harness.traffic_file(cell["traffic"])
    if test:
        cfg = {**cfg, **TINY[cell["config"]]}
        mix = {**mix, **TINY_TRAFFIC[mix["driver"]]}
        dev = torch.device("cpu")
    else:
        harness.require_cards(cell["chips"])
        dev = torch.device("cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        if mix["driver"] == "serve_daemon":
            got = _serving(cfg, mix, seed, dev)
        else:
            got = _training(mix["driver"], cfg, mix, seed, dev, kind)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {k: {"value": got[k], "limit": lim} for k, lim in mix["limits"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="fp8", choices=sorted(KINDS))
    ap.add_argument("--test", action="store_true")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        r = readings(args.workload, int(s), args.test, args.kind)
        broken = any(v["value"] > v["limit"] for v in r.values())
        print(json.dumps({"workload": args.workload, "seed": int(s), "kind": args.kind,
                          "readings": r, "broke_a_limit": broken}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
