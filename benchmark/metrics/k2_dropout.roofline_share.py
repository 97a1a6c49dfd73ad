"""The dropout kernel K2 (forward and backward applications): each launch's
least time from its element count and dtype (``roofline.k2_bound_s``)
summed, over the device time the profiler gave it, in %."""
import math

from benchmark import roofline
from benchmark.metrics._common import roofline_share

ITEMSIZE = {"c10::BFloat16": 2, "BFloat16": 2, "float": 4, "Float": 4}


def _k2(shapes, dtypes):
    return roofline.k2_bound_s(math.prod(shapes[0]), ITEMSIZE.get(dtypes[0], 2))


def read(run):
    return roofline_share(run, {"mmst_torch::dropout_apply": _k2})
