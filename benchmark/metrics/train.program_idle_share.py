"""Share (%) of the traced first half's ``window_s`` in which the card was
idle while a span of the program was open on the host as the gap began.
The gaps are the holes in the union of ``run.trace.intervals``; idle time
that began in the benchmark's loop or outside every span is left out, so
the share is at most ``train.device_idle_share``."""
from benchmark.metrics._spans import gap_owners, recorded
from benchmark.trace import _union


def read(run):
    recs = recorded(run)
    if recs is None or run.trace.window_s <= 0:
        return None
    _, gaps = _union([(s, e) for _, s, e in run.trace.intervals])
    owned = sum(g1 - g0 for g0, g1, owner in gap_owners(gaps, recs) if owner is not None)
    return 100.0 * owned / run.trace.window_s
