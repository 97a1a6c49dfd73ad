"""The relayout kernel K4 (``csrc/relayout.cu``): a (B, C, T) tensor cast
and stored channel-first contiguous or channel-last (the transpose view of
a contiguous (B, T, C)), in one pass, through the ``mmst_torch::relayout``
operator. On the card the operator launches K4, a tiled transpose with the
cast, for float32 and bfloat16, and raises for any other dtype; on the CPU
it is the plain ``copy_`` (float64 too, the CPU's yardstick). Its callers
(``models/layers.py``) call it only where the layout changes: a tensor
already stored as asked needs a plain cast, not a transpose."""
from __future__ import annotations

import torch

from . import _library

LAUNCHES = _library.LaunchCounts("relayout")

# the operator's own dtype codes (csrc/mmst_ops.cpp relayout_type)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)  # K4's, on the card


def reset_launches() -> None:
    LAUNCHES.reset()


def relayout(x: torch.Tensor, dtype: torch.dtype, channel_first: bool) -> torch.Tensor:
    """``x`` as ``dtype``, stored channel-first contiguous (``channel_first``)
    or channel-last."""
    return _library.ops().relayout(x, DTYPE_CODES[dtype], channel_first)
