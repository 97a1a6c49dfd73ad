"""Profiling and debugging support: the port's counterpart of the JAX
package's ``utils/profiling.py``.

  - ``trace_annotation(name)``: a named span in torch.profiler's trace (and
    an NVTX range on the card), the counterpart of
    ``jax.profiler.TraceAnnotation``;
  - ``device_trace(log_dir)``: torch.profiler over the CPU and the card,
    written as a Chrome trace, ``log_dir/trace.json``;
  - ``StepTimer``: step times and the frames/s throughput (the JAX class's
    API). PyTorch returns before the card has run a step, so the timer
    synchronises the device it times on entry and on exit;
  - ``nan_debugging()`` / ``enable_nan_debugging()``: the counterpart of
    ``jax_debug_nans``. Anomaly detection checks the backward, and a
    ``TorchDispatchMode`` raises ``FloatingPointError``, naming the
    operator, on the first floating output that holds a NaN. The hand-
    written glue and dropout kernels are checked too: they are called
    through their ``mmst_torch`` operators, which the mode sees. Every
    checked output costs a device sync;
    it is a debugging mode;
  - ``enable_persistent_compile_cache()``: the port compiles nothing at run
    time except its CUDA kernels and their operator library
    (``ops/kernels/_build.py``), so it builds them all ahead, into the
    build directory that later processes reuse.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..device import resolve_device

# operators that return uninitialised memory: a NaN there is not a result
ALLOCATION_OPS = frozenset({"empty", "empty_like", "empty_strided", "empty_permuted",
                            "new_empty", "new_empty_strided", "resize_", "set_"})


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region in the profiler's timeline (and in NVTX on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block on the CPU and, where there is one, the card;
    writes ``log_dir/trace.json`` (chrome://tracing, Perfetto). Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sum its events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing and the throughput derived from it.

    ``frames_per_item`` defaults to the 860 spectrogram frames of a chunk,
    so rates are the train-step metric (frames/s). On a CUDA ``device``
    (the default) entering and leaving the timer synchronise the card, so
    a step is timed from an idle card until its work has run."""

    def __init__(self, frames_per_item: int = 860, device: str | torch.device | None = "cuda"):
        self.frames_per_item = frames_per_item
        self.device = resolve_device(device)
        self.times: list[float] = []
        self._t0: float | None = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    def mean_step_time(self, skip_first: int = 1) -> float:
        ts = self.times[skip_first:] or self.times
        return sum(ts) / len(ts)

    def frames_per_sec(self, batch_size: int, skip_first: int = 1) -> float:
        return batch_size * self.frames_per_item / self.mean_step_time(skip_first)


class NanCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` on the first operator whose floating
    output holds a NaN; ``seen`` counts the operators it checked, by name."""

    def __init__(self):
        super().__init__()
        self.seen: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        self.seen[name] += 1
        if func.overloadpacket.__name__ in ALLOCATION_OPS:
            return out
        for t in pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {name} ({tuple(t.shape)} {t.dtype} on {t.device})")
        return out


@contextlib.contextmanager
def nan_debugging():
    """Fail fast on NaNs inside the block; yields the ``NanCheckMode``."""
    with torch.autograd.set_detect_anomaly(True), NanCheckMode() as mode:
        yield mode


def enable_nan_debugging():
    """``nan_debugging`` for the rest of this thread; returns the entered
    context, whose ``__exit__(None, None, None)`` leaves it."""
    ctx = nan_debugging()
    ctx.__enter__()
    return ctx


def enable_persistent_compile_cache(device: str | torch.device | None = "cuda") -> str | None:
    """Build every CUDA kernel ahead, so no request or step pays for nvcc;
    returns the build directory (``ml_music_style_transfer_tpu_torch/_build``
    keyed by the sources' hash, reused by every later process). Nothing is
    built for a CPU ``device`` or with ``MMST_COMPILE_CACHE=0``; then it
    returns None."""
    from ..ops.kernels import _build

    if os.environ.get("MMST_COMPILE_CACHE") == "0" or resolve_device(device).type != "cuda":
        return None
    _build.build_all()
    return _build.ops_build_dir()
