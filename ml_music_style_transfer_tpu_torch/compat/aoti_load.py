"""Load and run an AOTInductor package of ``compat/program_export.py`` from
a Python process that imports ``torch`` and nothing of this repository.

    python aoti_load.py PACKAGE.pt2 LIBMMST_OPS.so INPUTS.pt OUTPUT.pt [RUNS]

The operator library (``libmmst_ops.so``, ``ops/kernels/_build.py``) is
loaded by path first, since a package calls the ``mmst_torch`` operators;
then the package, with ``torch._inductor.aoti_load_package``. INPUTS.pt is
the program's inputs flattened in call order, a list of tensors
(``program_export.save_flat_inputs``), moved to the package's device but
those its metadata lists under ``mmst_host_inputs`` (the iteration count),
which stay on the host. Float32 convolutions and matmuls run without TF32,
as the package's float32 program computes.
The package runs RUNS times (default 1); the last run's outputs are saved
as a list of CPU tensors. One JSON line reports the device, the seconds to
load and to run (each run ended by a device synchronisation), each
operator entry's CUDA launches and CPU calls per run, and the modules of
this repository the process imported (none).

Run it as a script (its file path), so that its package is not imported.
"""
from __future__ import annotations

import json
import sys
import time

import torch


def load(package: str, ops_library: str):
    """The package's compiled model, the operator library loaded first."""
    torch.ops.load_library(ops_library)
    return torch._inductor.aoti_load_package(package)


def _counts(ops, device: str) -> list[int]:
    return [ops.launch_count(e, device) for e in ops.launch_entries()]


def main(argv: list[str]) -> dict:
    package, ops_library, inputs, output = argv[:4]
    runs = int(argv[4]) if len(argv) > 4 else 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = load(package, ops_library)
    load_s = time.perf_counter() - t0
    meta = model.loader.get_metadata()
    device = meta["AOTI_DEVICE_KEY"]
    host = {int(i) for i in meta.get("mmst_host_inputs", "").split(",") if i}
    flat = [t if i in host else t.to(device) for i, t in enumerate(torch.load(inputs))]
    ops = torch.ops.mmst_torch
    entries = list(ops.launch_entries())
    run_s, calls = [], {e: {"cuda": [], "cpu": []} for e in entries}
    with torch.inference_mode():
        for _ in range(runs):
            before = {d: _counts(ops, d) for d in ("cuda", "cpu")}
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.loader.run(flat)
            if device == "cuda":
                torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
            for d in ("cuda", "cpu"):
                for e, a, b in zip(entries, before[d], _counts(ops, d)):
                    calls[e][d].append(b - a)
    torch.save([t.cpu() for t in out], output)
    return {"device": device, "load_s": load_s, "run_s": run_s, "launches": calls,
            "repo_modules": sorted(m for m in sys.modules
                                   if m.startswith("ml_music_style_transfer_tpu"))}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
