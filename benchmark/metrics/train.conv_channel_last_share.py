"""Share (%) of the convolutions' calls over the traced first half's steps
whose input reached cuDNN channel-last: the sum of the ``train.step``
spans' ``conv_channel_last_calls`` counters over the sum of their
``conv_calls`` (a counter that did not move in a step is left off it). None
where no step counted a convolution, as in a program without the
counters."""
from benchmark.metrics._spans import first_steps


def read(run):
    steps = first_steps(run)
    if steps is None:
        return None
    counted = [r.counters for recs in steps.values() for r in recs
               if r.name == "train.step" and r.counters.get("conv_calls")]
    if not counted:
        return None
    calls = sum(c["conv_calls"] for c in counted)
    return 100.0 * sum(c.get("conv_channel_last_calls", 0) for c in counted) / calls
