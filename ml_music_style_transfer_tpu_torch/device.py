"""Device selection for the port's entry points.

Counterpart of ``ml_music_style_transfer_tpu/ops/pallas/__init__.py:on_tpu``,
with one difference in contract: the port never picks the CPU by itself.
The card is the default; the CPU is used only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises RuntimeError for a CUDA device when no card is present, so an
    entry point never carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
