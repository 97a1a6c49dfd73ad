"""Arithmetic the readers share."""
from __future__ import annotations

from benchmark import roofline


def idle_share(run):
    """Share (%) of the traced span with nothing running on the card."""
    t = run.trace
    if t is None or t.window_s <= 0 or not t.intervals:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)


def roofline_share(run, bounds: dict):
    """Sum of the least times of the launches of the operators in
    ``bounds`` ({operator name: fn(shapes, dtypes) -> seconds}) over the
    device time the profiler gave their kernels, in %."""
    t = run.trace
    if t is None:
        return None
    least = spent = 0.0
    for op, bound in bounds.items():
        for shapes, dtypes, seconds in t.ops.get(op, []):
            least += bound(shapes, dtypes)
            spent += seconds
    return 100.0 * least / spent if spent > 0 else None


def untraced_end(run) -> float:
    """Where the run's own records stop counting: the profiler's start in a
    traced run, else the window's close."""
    return run.trace.t0 if run.trace is not None else run.records["end"]


def mfu(flops: float, seconds: float):
    return 100.0 * flops / (seconds * roofline.BF16_FLOPS_PER_S) if seconds > 0 else None
