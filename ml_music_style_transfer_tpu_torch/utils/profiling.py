"""Tracing, profiling and debugging support: the port's counterpart of the
JAX package's ``utils/profiling.py``.

  - ``span(name)``: a span of the program. It is recorded while a
    ``torch.profiler`` runs in this process (``device_trace``, or any
    other); otherwise it is a shared no-op and costs one check of the
    profiler's state. A recorded span keeps its name; its host start and
    end by ``time.time_ns()``, the clock of the profiler's own events, so
    spans line up with the device trace; its id, its parent's and its
    step's (``step=True`` opens a new step; a span inside a step belongs to
    it, one outside every step to the step that opens next); on the card
    the device seconds between two CUDA events recorded on the current
    stream at its ends (``device=False``: none); and its counters: a step
    counts the caching allocator's ``cudaMalloc`` and ``cudaFree`` calls
    while it is open (``allocator_calls``), and how far each of the
    program's own counts (``register_counts``) moved, those that did. It also opens a
    ``record_function`` range of its name, so the profiler's trace shows
    the program's spans among the operators and kernels;
  - ``register_counts(counts)``: a dict of running counts that a module
    keeps (the convolutions' calls, ``models/layers.py``), which every
    recorded step then reads at its ends;
  - ``setup_span(name)``: a span of set-up, recorded in every run, with
    host times only, so a traced run can read set-up by phase afterwards;
  - ``spans()``: the recorded spans in the order they closed, with their
    device seconds (resolving them waits for the card); ``clear_spans()``
    empties the store, which keeps ``MAX_SPANS`` spans and counts those it
    drops past that (``dropped_spans()``);
  - ``device_trace(log_dir)``: torch.profiler over the CPU and the card,
    written as a Chrome trace, ``log_dir/trace.json``, the spans included;
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
import dataclasses
import itertools
import os
import threading
import time

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..device import resolve_device

# operators that return uninitialised memory: a NaN there is not a result
ALLOCATION_OPS = frozenset({"empty", "empty_like", "empty_strided", "empty_permuted",
                            "new_empty", "new_empty_strided", "resize_", "set_"})

MAX_SPANS = 1 << 16

# the program's running counts (register_counts), read by every recorded step
_COUNTS: list[dict] = []


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    """One recorded span. Host times in ns by ``time.time_ns()``;
    ``device_s`` None where no CUDA events were recorded."""
    name: str
    id: int
    parent: int | None
    step: int | None
    start_ns: int
    end_ns: int = 0
    device_s: float | None = None
    counters: dict = dataclasses.field(default_factory=dict)
    events: tuple | None = dataclasses.field(default=None, repr=False)


def _allocator_calls() -> int | None:
    """The caching allocator's ``cudaMalloc`` and ``cudaFree`` calls so far
    (each stalls the stream); None before CUDA is initialised."""
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats_as_nested_dict()
    return stats.get("num_device_alloc", 0) + stats.get("num_device_free", 0)


def register_counts(counts: dict) -> dict:
    """Register ``counts``, a dict of running integer counts that its owner
    updates: a recorded step carries, among its counters, how far each of
    them moved while it was open. Returns ``counts``."""
    _COUNTS.append(counts)
    return counts


def _program_counts() -> dict:
    return {k: v for counts in _COUNTS for k, v in counts.items()}


class _Store:
    """The process's spans: the closed ones, the open ones of each thread,
    the next ids and a pool of CUDA events."""

    def __init__(self):
        self.lock = threading.Lock()
        self.closed: list[Span] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.next_step = 1
        self.events: list = []
        self.local = threading.local()

    def open_stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def event(self):
        with self.lock:
            if self.events:
                return self.events.pop()
        return torch.cuda.Event(enable_timing=True)

    def close(self, rec: Span) -> None:
        with self.lock:
            if len(self.closed) < MAX_SPANS:
                self.closed.append(rec)
                return
            self.dropped += 1
            if rec.events is not None:
                self.events.extend(rec.events)


_STORE = _Store()
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


class _Recording:
    """The context of one recorded span."""

    __slots__ = ("rec", "new_step", "device", "setup", "range", "allocs", "counts")

    def __init__(self, name: str, new_step: bool, device: bool, setup: bool):
        self.rec = Span(name, 0, None, None, 0)
        self.new_step, self.device, self.setup = new_step, device, setup
        self.range = self.allocs = self.counts = None

    def __enter__(self):
        rec, store = self.rec, _STORE
        stack = store.open_stack()
        parent = stack[-1] if stack else None
        rec.id = next(store.ids)
        if parent is not None:
            rec.parent, rec.step = parent.id, parent.step
        if self.new_step:
            with store.lock:
                rec.step = store.next_step
                store.next_step += 1
        elif parent is None and not self.setup:
            rec.step = store.next_step
        stack.append(rec)
        rec.start_ns = time.time_ns()
        if _profiler_enabled():
            self.range = torch.autograd.profiler.record_function(rec.name)
            self.range.__enter__()
        if self.new_step:
            self.allocs = _allocator_calls()
            self.counts = _program_counts()
        if self.device and torch.cuda.is_initialized():
            rec.events = (store.event(), store.event())
            rec.events[0].record()
        return rec

    def __exit__(self, *exc):
        rec, store = self.rec, _STORE
        if rec.events is not None:
            rec.events[1].record()
        if self.allocs is not None:
            rec.counters["allocator_calls"] = _allocator_calls() - self.allocs
        if self.counts is not None:
            rec.counters.update((k, v - self.counts.get(k, 0))
                                for k, v in _program_counts().items()
                                if v != self.counts.get(k, 0))
        if self.range is not None:
            self.range.__exit__(*exc)
        rec.end_ns = time.time_ns()
        store.open_stack().remove(rec)
        store.close(rec)
        return False


def span(name: str, step: bool = False, device: bool = True):
    """A span of the program named ``name`` (see the module docstring):
    recorded while a profiler runs, else a no-op."""
    if not _profiler_enabled():
        return _OFF
    return _Recording(name, step, device, False)


def setup_span(name: str):
    """A span of set-up named ``name``, recorded whether or not a profiler
    runs: host times, no step."""
    return _Recording(name, False, False, True)


def spans() -> list[Span]:
    """The recorded spans, in the order they closed, each with its device
    seconds (waits for the events of those not read before)."""
    store = _STORE
    with store.lock:
        for rec in store.closed:
            if rec.events is not None:
                start, end = rec.events
                end.synchronize()
                rec.device_s = start.elapsed_time(end) / 1e3
                rec.events = None
                store.events += (start, end)
        return list(store.closed)


def clear_spans() -> None:
    """Empty the store and its count of dropped spans."""
    store = _STORE
    with store.lock:
        for rec in store.closed:
            if rec.events is not None:
                store.events += rec.events
        store.closed, store.dropped = [], 0


def dropped_spans() -> int:
    """Spans closed since the last ``clear_spans`` that the full store dropped."""
    return _STORE.dropped


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block on the CPU and, where there is one, the card;
    writes ``log_dir/trace.json`` (chrome://tracing, Perfetto), where the
    program's spans appear as ranges among the operators. Yields the
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
    with setup_span("setup.library"):
        _build.build_all()
    return _build.ops_build_dir()
