"""Build the port's native libraries from the sources in ``csrc/`` at first use.

Two routes, each into ``ml_music_style_transfer_tpu_torch/_build/<hash>/``
(listed in ``.gitignore``), keyed by a hash of that route's own sources,
flags and toolchain, so a changed source rebuilds and an unchanged one is
loaded as it is:

  - the operator library ``libmmst_ops.so`` (``build_all``): the kernels'
    ``mmst_torch`` operators defined in ``csrc/mmst_ops.cpp`` with
    ``TORCH_LIBRARY``, compiled by ``g++`` against PyTorch's headers and
    linked to libtorch. Where PyTorch is built with CUDA, each
    ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
    ``lib<name>.so`` with a plain C interface (no PyTorch headers), all of
    them and the ``g++`` compile started together, and the operator
    library is linked to them; elsewhere (a CPU-only PyTorch) it holds the
    CPU and Meta implementations alone. The hash covers PyTorch's version
    and C++ ABI, so a library linked against one libtorch is never loaded
    into another. ``build_runner`` links the Python-less AOTInductor
    runner (``csrc/aoti_runner.cpp``) to it;
  - host C++: each other ``csrc/<name>.cpp`` is compiled by ``g++`` into a
    plain C library (no PyTorch headers) when first loaded with ``ctypes``
    (``load_host``). A change to one does not rebuild the operators.

Builds take a file lock, so processes that start together (test workers)
build once, and write each file under a temporary name before renaming
it. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
OPS_SOURCE = "mmst_ops.cpp"
RUNNER_SOURCE = "aoti_runner.cpp"
TORCH_SOURCES = (OPS_SOURCE, RUNNER_SOURCE)  # compiled against libtorch, not by load_host
OPS_LIBRARY = "libmmst_ops.so"

_lock = threading.RLock()
# compiler output of the last build, per source (nvcc's registers and spills)
build_log: dict[str, str] = {}


def _sources(ext: str = ".cu") -> list[str]:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(ext) and f not in TORCH_SOURCES)


def with_cuda() -> bool:
    """Whether the operator library is built with the CUDA kernels: where
    this PyTorch is built for CUDA."""
    return torch.version.cuda is not None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX); the native libraries cannot be built")


@functools.cache
def openmp_cxx() -> str:
    """A C++ compiler that builds and links an OpenMP shared library here,
    for AOTInductor, which compiles every package with ``-fopenmp`` (a
    ``g++`` first on the PATH may lack its OpenMP runtime): the first of
    ``$CXX``, ``g++``, ``c++``, the system's ``g++-N`` and ``clang++``.
    Raises if none does."""
    import glob
    import tempfile

    cands = [os.environ.get("CXX"), "g++", "c++", "/usr/bin/g++", "/usr/bin/c++",
             *sorted(glob.glob("/usr/bin/g++-[0-9]*"), reverse=True), "clang++"]
    tried = []
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cpp")
        with open(src, "w") as f:
            f.write("#include <omp.h>\n"
                    "extern \"C\" int threads() { return omp_get_max_threads(); }\n")
        for cand in dict.fromkeys(c for c in cands if c):
            path = shutil.which(cand)
            if path is None:
                continue
            proc = subprocess.run([path, "-fopenmp", "-shared", "-fPIC", "-o",
                                   os.path.join(tmp, "omp.so"), src, "-lgomp"],
                                  capture_output=True, text=True)
            if proc.returncode == 0:
                return path
            tried.append(f"{path}: {proc.stderr.strip()[-300:]}")
    raise RuntimeError("no C++ compiler here builds with -fopenmp, which AOTInductor "
                       "needs:\n" + "\n".join(tried))


def _hashed_dir(parts: list[str], sources: list[str]) -> str:
    h = hashlib.sha256("\0".join(parts).encode())
    for name in sources:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _torch_lib_dir() -> str:
    return os.path.join(os.path.dirname(torch.__file__), "lib")


def _torch_cxx_flags() -> list[str]:
    """g++ flags for a source that includes PyTorch's headers: its C++ ABI
    (``torch._C._GLIBCXX_USE_CXX11_ABI``), C++20 (the headers of torch 2.13
    warn under C++17), and with CUDA the toolkit's headers."""
    from torch.utils import cpp_extension

    flags = ["-O2", "-std=c++20", "-fPIC", "-pthread",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    if with_cuda():
        flags += ["-DMMST_WITH_CUDA", f"-I{os.path.dirname(os.path.dirname(_nvcc()))}/include"]
    return flags


def _torch_link_flags() -> list[str]:
    """libtorch, loaded whether or not a symbol of it is named (the CUDA
    parts register PyTorch's CUDA backend), found at run time by rpath."""
    libs = ["torch", "torch_cpu", "c10"] + (["torch_cuda", "c10_cuda"] if with_cuda() else [])
    return (["-L", _torch_lib_dir(), "-Wl,--no-as-needed"] + [f"-l{n}" for n in libs]
            + ["-Wl,--as-needed", f"-Wl,-rpath,{_torch_lib_dir()}"])


def ops_build_dir() -> str:
    """Where the operator library of the current sources, flags and PyTorch
    is built, with the kernel libraries beside it."""
    kernels = _sources() if with_cuda() else []
    parts = [f"torch {torch.__version__}", f"cxx11abi {int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             f"cuda {torch.version.cuda}", *HOST_FLAGS, *(NVCC_FLAGS if kernels else ())]
    return _hashed_dir(parts, kernels + [OPS_SOURCE])


def library_path(name: str) -> str:
    """Where ``lib<name>.so`` of kernel ``csrc/<name>.cu`` is built."""
    return os.path.join(ops_build_dir(), f"lib{name}.so")


def ops_library_path() -> str:
    """Where the operator library ``libmmst_ops.so`` is built."""
    return os.path.join(ops_build_dir(), OPS_LIBRARY)


def runner_path() -> str:
    """Where the Python-less AOTInductor runner is built: a directory keyed
    by its source and by the operator library it links to."""
    return os.path.join(_hashed_dir([ops_build_dir()], [RUNNER_SOURCE]), "aoti_runner")


@contextlib.contextmanager
def _locked(out_dir: str):
    """This thread's and this process's hold on ``out_dir``'s builds: one
    build at a time, across threads and processes."""
    os.makedirs(out_dir, exist_ok=True)
    with _lock, open(out_dir + ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _start(name: str, cmd: list[str], tmp: str, final: str) -> tuple:
    return name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True), tmp, final


def _finish(jobs: list[tuple], what: str) -> None:
    """Wait for every build job; rename each success into place, then raise
    on any failure."""
    failed = []
    for name, proc, tmp, final in jobs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, final)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError(f"{what} build failed:\n" + "\n".join(failed))


def build_all() -> float:
    """Build the operator library, with every CUDA kernel where PyTorch has
    CUDA (one ``nvcc`` per ``.cu`` and the ``g++`` compile of the
    operators, started together, then one link), unless it is built
    already; returns the seconds taken."""
    t0 = time.perf_counter()
    out_dir = ops_build_dir()
    lib = os.path.join(out_dir, OPS_LIBRARY)
    with _locked(out_dir):
        if os.path.exists(lib):
            return time.perf_counter() - t0
        tag = f".{os.getpid()}.tmp"
        jobs, kernels = [], _sources() if with_cuda() else []
        nvcc = _nvcc() if kernels else None
        for src in kernels:
            final = os.path.join(out_dir, f"lib{src[:-3]}.so")
            jobs.append(_start(src, [nvcc, *NVCC_FLAGS, "-o", final + tag,
                                     os.path.join(CSRC_DIR, src)], final + tag, final))
        obj = os.path.join(out_dir, "mmst_ops.o")
        jobs.append(_start(OPS_SOURCE, [_cxx(), *_torch_cxx_flags(), "-c", "-o", obj + tag,
                                        os.path.join(CSRC_DIR, OPS_SOURCE)], obj + tag, obj))
        _finish(jobs, "operator library")
        link = [_cxx(), "-shared", "-o", lib + tag, obj, "-L", out_dir,
                "-Wl,--no-as-needed", *[f"-l{s[:-3]}" for s in kernels], "-Wl,--as-needed",
                "-Wl,-rpath,$ORIGIN", *_torch_link_flags()]
        _finish([_start(OPS_LIBRARY, link, lib + tag, lib)], "operator library link")
    return time.perf_counter() - t0


def build_runner() -> str:
    """Build the AOTInductor runner (``csrc/aoti_runner.cpp``), linked to
    the operator library and to libtorch and to no Python, unless it is
    built already; returns its path."""
    build_all()
    ops_dir, exe = ops_build_dir(), runner_path()
    with _locked(os.path.dirname(exe)):
        if not os.path.exists(exe):
            tag = f".{os.getpid()}.tmp"
            cmd = [_cxx(), *_torch_cxx_flags(), "-o", exe + tag,
                   os.path.join(CSRC_DIR, RUNNER_SOURCE), "-L", ops_dir, "-Wl,--no-as-needed",
                   "-lmmst_ops", "-Wl,--as-needed", f"-Wl,-rpath,{ops_dir}",
                   *_torch_link_flags()]
            _finish([_start(RUNNER_SOURCE, cmd, exe + tag, exe)], "AOTInductor runner")
    return exe


def host_library_path(name: str) -> str:
    """Where ``lib<name>.so`` of the current host sources and flags is built."""
    return os.path.join(_hashed_dir([" ".join(HOST_FLAGS)], _sources(".cpp")), f"lib{name}.so")


def load_host(name: str) -> ctypes.CDLL:
    """``lib<name>.so`` from ``csrc/<name>.cpp``, built by the C++ compiler
    at first use."""
    path = host_library_path(name)
    with _locked(os.path.dirname(path)):
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_cxx(), *HOST_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cpp")]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"host library build failed: {name}.cpp "
                                   f"(exit {proc.returncode}):\n{build_log[name]}")
            os.replace(tmp, path)  # atomic: a reader never sees half a file
    return ctypes.CDLL(path)
