"""Seeded weights, made on the device in one draw: a standard normal over
all parameters at once, each leaf then scaled in place, weights by
xavier-normal's sqrt(2 / (fan_in + fan_out)) and biases by 0.01. The
program and the reference get the same numbers from the same seed."""
from __future__ import annotations

import math

import torch

BIAS_STD = 0.01


def make(shapes: dict, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape in shapes.items():
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            if len(shape) == 1:
                t.mul_(BIAS_STD)
            else:
                rf = math.prod(shape[2:])
                t.mul_(math.sqrt(2.0 / ((shape[0] + shape[1]) * rf)))
            out[name] = t
    return out
