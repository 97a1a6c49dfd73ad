"""What the readers of the program's own spans share.

The program records its spans through
``ml_music_style_transfer_tpu_torch.utils.profiling`` while a profiler
runs: name, id, parent, step id, host start and end in ns by
``time.time_ns()`` (the clock of ``run.trace.intervals``, which the
profiler gives in s), device seconds between CUDA events, and counters.
Set-up spans (``setup.*``) are recorded in every run.

A reader reads a traced run on the card. It returns None where the run has
no device intervals or the program recorded no spans (a program without
them included), so such a run leaves the metric out. Per-step readers use
the steps whose ``train.step`` closed inside the tracer's first half, the
one that records the card's activity alone: from the first start to the
last end of ``run.trace.intervals``.
"""
from __future__ import annotations

import statistics

from benchmark.trace import _union

NS = 1e-9


def recorded(run):
    """The program's spans, or None."""
    t = run.trace
    if t is None or not t.intervals:
        return None
    from ml_music_style_transfer_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return (read() or None) if read is not None else None


def first_steps(run):
    """{step id: its spans} of the steps whose ``train.step`` closed inside
    the first half, or None."""
    recs = recorded(run)
    if recs is None:
        return None
    lo = min(s for _, s, _ in run.trace.intervals)
    hi = max(e for _, _, e in run.trace.intervals)
    steps = {r.step: [] for r in recs if r.name == "train.step" and lo <= r.end_ns * NS <= hi}
    for r in recs:
        if r.step in steps:
            steps[r.step].append(r)
    return steps or None


def phase_ms(run, name: str):
    """Median over the first half's steps of the device ms of the step's
    spans named ``name``."""
    steps = first_steps(run)
    if steps is None:
        return None
    per_step = []
    for recs in steps.values():
        ms = [1e3 * r.device_s for r in recs if r.name == name and r.device_s is not None]
        if ms:
            per_step.append(sum(ms))
    return statistics.median(per_step) if per_step else None


def setup_s(run, name: str):
    """Host seconds covered by the spans named ``name`` (their union)."""
    recs = recorded(run)
    if recs is None:
        return None
    spans = [(r.start_ns, r.end_ns) for r in recs if r.name == name]
    return _union(spans)[0] * NS if spans else None


def gap_owners(gaps, recs):
    """(start, end, owner) of each gap (s), the owner the innermost span
    (latest start, any thread) open on the host as the gap began, or None."""
    spans = sorted(((r.start_ns * NS, r.end_ns * NS, r) for r in recs), key=lambda s: s[0])
    i, open_ = 0, []
    for g0, g1 in sorted(gaps):
        while i < len(spans) and spans[i][0] <= g0:
            open_.append(spans[i])
            i += 1
        open_ = [s for s in open_ if s[1] > g0]
        yield g0, g1, (open_[-1][2] if open_ else None)
