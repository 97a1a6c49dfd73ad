"""Export the deployment programs (forward, Griffin-Lim, serving) as
``torch.export`` ``.pt2`` files: the port's counterpart of the JAX
package's ``scripts/export_stablehlo.py``, with its flags; ``--platforms``
becomes ``--device``, and ``--n-iter`` goes: the Griffin-Lim iteration count
is a program input.

    python -m ml_music_style_transfer_tpu_torch.scripts.export_program --out DIR \\
        [--width-mult 1.0] [--compat-mbr-noop] [--t 860] [--batch 1] \\
        [--frames 860] [--serving-n-tiles 8] [--serving-audio-seconds 30] \\
        [--device cuda|cpu] [--aoti]

Parameters, the Griffin-Lim initial phase and its iteration count are
program inputs (``n_iter``: ``program_export.iterations``), so one
export serves every checkpoint of the configuration
(``compat/program_export.py``). A program exported on the card runs there
and launches the hand-written glue kernels; one exported with ``--device
cpu`` runs their plain versions on the CPU. ``--serving-n-tiles 0`` skips
the serving program. Load a program with ``program_export.load_artifact``
(or ``torch.export.load`` after ``ops.kernels.ops()``, which loads the
operators it names).

``--aoti`` also compiles each program with AOTInductor into
``{name}.aoti.pt2``, a package that runs with no Python: on the card
unless ``--device cpu`` is given. Run one with the C++ runner
(``ops/kernels/_build.build_runner()``; ``aoti_runner PACKAGE INPUTS
OUTPUT [RUNS]``) or ``compat/aoti_load.py``; both need the operator
library ``libmmst_ops.so`` (``_build.ops_library_path()``).
"""
from __future__ import annotations

import argparse
import json
import os

from ..compat import program_export
from ..config import ModelConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--compat-mbr-noop", action="store_true")
    ap.add_argument("--t", type=int, default=860)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=860)
    ap.add_argument("--serving-n-tiles", type=int, default=8,
                    help="MIDI tile count of the serving program (0 skips it)")
    ap.add_argument("--serving-audio-seconds", type=float, default=30.0,
                    help="timbre-audio length of the serving program")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--aoti", action="store_true",
                    help="also compile each program into an AOTInductor package")
    args = ap.parse_args(argv)

    cfg = ModelConfig(width_mult=args.width_mult, compat_mbr_noop=args.compat_mbr_noop)
    paths = program_export.write_artifacts(
        args.out, cfg, t=args.t, batch=args.batch, frames=args.frames,
        device=args.device, serving_n_tiles=args.serving_n_tiles,
        serving_audio_samples=int(args.serving_audio_seconds * 44100), aoti=args.aoti)
    with open(paths["manifest"]) as f:
        manifest = json.load(f)
    seconds = manifest["export_seconds"]
    aoti_seconds = manifest.get("aoti_compile_seconds", {})
    for name, p in paths.items():
        took = f", exported in {seconds[name]:.1f} s" if name in seconds else ""
        if name.endswith(".aoti"):
            took = f", compiled in {aoti_seconds[name[:-5]]:.1f} s"
        print(f"{name}: {p} ({os.path.getsize(p)} bytes{took})")
    return paths


if __name__ == "__main__":
    main()
