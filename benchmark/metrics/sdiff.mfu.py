"""3 x the forward FLOPs of a Spectrogram Diffusion step (forward, and
backward at twice the forward), counted over every note position the
program computes, padding included (``sdiff_roofline.forward_flops``), x
the steps done, over their seconds at the bf16 peak, in %: the window up to
the profiler's start, where the card was drained, so every step issued
before it was done."""
from benchmark import sdiff_roofline
from benchmark.metrics._common import mfu


def read(run):
    rec = run.records
    if "steps" not in rec:
        return None
    cut = run.trace.t0 if run.trace is not None else rec["t0"] + rec["seconds"]
    steps = sum(1 for t in rec["issued"] if t < cut)
    if not steps:
        return None
    fwd = sdiff_roofline.forward_flops(run.config, rec["batch"])
    return mfu(3 * fwd * steps, cut - rec["t0"])
