"""The control of ``correct`` in the Spectrogram Diffusion cells, as
``control.py`` is for the older ones: the reference put in the program's
place, computed one precision below the configuration's (float8 e4m3 inputs
and weights of every linear, where the configuration states bfloat16), and
judged by the same numbers against the same limits. It has to come out not
correct.

    python -m benchmark.sdiff_control --workload sdiff-train-b8 --seeds 1,2,3 [--kind K] [--test]

runs on the card at the cell's own sizes (``--test``: the CPU test sizes
below) and prints one JSON line per seed. ``--kind`` plants a fault in the
reference put in the program's place instead (``control.KINDS``:
``half_batch``, ``scaled_loss``); a step that leaves the weights unchanged
reads 1 in ``change_gap`` by construction.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import control, harness
from .drivers import train_spectrogram_diffusion as train_sdiff
from .reference import nets
from .reference import steps as ref_steps

# the CPU tests' sizes: d_model 64, 2 heads, 2 layers a stack, 64 note
# tokens, 16 frames; fewer notes, so that the 64 tokens hold padding
TINY = {"d_model": 64, "num_heads": 2, "d_kv": 32, "d_ff": 128, "num_notes_layers": 2,
        "num_context_layers": 2, "num_decoder_layers": 2, "max_length": 64,
        "targets_context_length": 16, "targets_length": 16}
TINY_TRAFFIC = {"batch": 4, "pool_batches": 2, "check_block": 2,
                "notes": {"median": 4, "sigma": 0.6, "min": 1, "max": 8}}


def readings(workload: str, seed: int, test: bool = False, kind: str = "fp8") -> dict:
    """The control's (or a fault's) numbers for one seed, each with its limit."""
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell, _, cfg = harness.find_cell(spec, workload)
    mix = harness.traffic_file(cell["traffic"])
    if test:
        cfg, mix, dev = {**cfg, **TINY}, {**mix, **TINY_TRAFFIC}, torch.device("cpu")
    else:
        harness.require_cards(cell["chips"])
        dev = torch.device("cuda")
    ref = train_sdiff.reference(cfg, mix, seed, dev)
    if kind == "fp8":
        got = train_sdiff.reference(cfg, mix, seed, dev, quant=nets.fp8)
    else:
        got = train_sdiff.reference(cfg, mix, seed, dev, fault=control.KINDS[kind])
    gaps = ref_steps.step_gaps(got, ref)
    return {k: {"value": gaps[k], "limit": lim} for k, lim in mix["limits"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="sdiff-train-b8")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="fp8", choices=sorted(control.KINDS))
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
