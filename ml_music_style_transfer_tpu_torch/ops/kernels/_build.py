"""Build the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``lib<name>.so``), loaded with ``ctypes``.
All sources are compiled at once, one ``nvcc`` each, started together.
Libraries land in ``ml_music_style_transfer_tpu_torch/_build/<hash>/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is loaded as it is. A failed
build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
# nvcc/ptxas output of the last build, per source (registers, spills)
build_log: dict[str, str] = {}


def _sources() -> list[str]:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> float:
    """Compile every source that has no library yet; returns seconds taken."""
    t0 = time.perf_counter()
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in _sources():
        name = src[:-3]
        lib_path = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(lib_path):
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib_path)
    failed = []
    for name, (proc, tmp, lib_path) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library_path(name: str) -> str:
    """Where ``lib<name>.so`` of the current sources and flags is built."""
    return os.path.join(_build_dir(), f"lib{name}.so")


def load(name: str) -> ctypes.CDLL:
    """``lib<name>.so`` loaded, building all kernels first if it is missing."""
    with _lock:
        path = library_path(name)
        if not os.path.exists(path):
            build_all()
        return ctypes.CDLL(path)
