"""Build the port's native libraries from the sources in ``csrc/`` at first use.

Two routes, each into ``ml_music_style_transfer_tpu_torch/_build/<hash>/``
(listed in ``.gitignore``), keyed by a hash of that route's own sources
and flags, so a changed source rebuilds and an unchanged one is loaded as
it is:

  - CUDA kernels: each ``csrc/<name>.cu`` is compiled by ``nvcc`` for
    ``sm_90a`` into a shared library with a plain C interface
    (``lib<name>.so``); all are compiled at once, one ``nvcc`` each,
    started together (``build_all``, ``load``);
  - host C++: each ``csrc/<name>.cpp`` is compiled by ``g++`` (no nvcc, so
    it builds on a machine without the CUDA toolkit) when first loaded
    (``load_host``). A change to a ``.cpp`` does not rebuild the kernels.

Every library is loaded with ``ctypes``. A failed build raises; nothing
falls back.
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

HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
# nvcc/ptxas output of the last build, per source (registers, spills)
build_log: dict[str, str] = {}


def _sources(ext: str = ".cu") -> list[str]:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(ext))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _build_dir(flags=NVCC_FLAGS, ext: str = ".cu") -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in _sources(ext):
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


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX); the host libraries cannot be built")


def host_library_path(name: str) -> str:
    """Where ``lib<name>.so`` of the current host sources and flags is built."""
    return os.path.join(_build_dir(HOST_FLAGS, ".cpp"), f"lib{name}.so")


def load_host(name: str) -> ctypes.CDLL:
    """``lib<name>.so`` from ``csrc/<name>.cpp``, built by the C++ compiler
    at first use."""
    with _lock:
        path = host_library_path(name)
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_cxx(), *HOST_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cpp")]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"host library build failed: {name}.cpp "
                                   f"(exit {proc.returncode}):\n{build_log[name]}")
            os.replace(tmp, path)  # atomic: a reader never sees half a file
        return ctypes.CDLL(path)
