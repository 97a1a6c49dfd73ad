"""Whole-clip forward on one device: the single-device part of the JAX
package's ``parallel/time_shard.py``.

The JAX package runs the whole clip through one forward with its time axis
sharded over a mesh (halo exchange for the convolutions, ``psum`` for the
InstanceNorm statistics), on a zero-padded clip whose statistics are masked
to the true length. Its tests hold that forward equal to the plain forward
on the unpadded clip (tests/test_inference.py:376-401), so on one card the
plain ``PerformanceNet`` on the unpadded clip is the counterpart. The halo
and ``psum`` machinery, and the time-sharded train step, wait for the
multi-device work (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import torch

from ..models import PerformanceNet


def time_sharded_output_length(t_valid: int, depth: int = 5) -> int:
    """The net's output frame count for a ``t_valid``-frame input (shape
    math of ``models/performance_net.temporal_ladder``)."""
    t = t_valid
    for _ in range(depth - 1):
        t //= 2
    for k in (6, 4, 3, 2):
        t = 2 * t + k - 4
    return t


def padded_length(t_valid: int, n_shards: int, depth: int = 5) -> int:
    """Smallest padded clip length the time-sharded forward takes over
    ``n_shards``: divisible by n_shards * 2^(depth-1) with >= 16 frames of
    headroom and at least 48 frames per shard (time_shard.py:309-317)."""
    unit = n_shards * 2 ** (depth - 1)
    t_pad = -(-(t_valid + 16) // unit) * unit
    return max(t_pad, 48 * n_shards)


@torch.inference_mode()
def whole_clip_forward(model: PerformanceNet, roll: torch.Tensor, cond: torch.Tensor,
                       onoff: torch.Tensor) -> torch.Tensor:
    """One forward over the whole unpadded clip: roll and onoff (1, T, 128),
    cond (1, T, 1025) -> (1, t_out, 1025) float32, InstanceNorm statistics
    over all T frames.

    Raises ValueError for a clip shorter than one frame at the deepest
    level (2^(depth-1) frames), which only the padded sharded forward takes.
    """
    t = roll.shape[1]
    depth = model.cfg.depth
    if t < 2 ** (depth - 1):
        raise ValueError(f"a {t}-frame clip is shorter than the {2 ** (depth - 1)} "
                         "frames the unpadded forward needs")
    out = model(roll.float(), cond, onoff.float())
    t_out = time_sharded_output_length(t, depth)
    if out.shape[1] != t_out:
        raise RuntimeError(f"forward gave {out.shape[1]} frames for a {t}-frame clip, "
                           f"expected {t_out}")
    return out.float()
