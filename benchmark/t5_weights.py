"""Seeded weights of Spectrogram Diffusion, made on the device in one draw: a
standard normal over all parameters at once, each leaf then scaled by T5's
initialisation (``reference/t5film.init_std``): norm weights 1, the
embedding 1, q ``(d_model d_kv)^-1/2``, k and v ``d_model^-1/2``, o
``(heads d_kv)^-1/2``, wi ``d_model^-1/2``, wo ``d_ff^-1/2``, and the linears
T5 does not have (input projections, the noise-time MLP, FiLM, the output)
xavier-normal, as ``weights.py`` scales them. The program and the reference
get the same numbers from the same seed. (``weights.make`` cannot serve:
it sets 1-D leaves to 0.01 N(0, 1), and a norm weight is 1.)"""
from __future__ import annotations

import math

import torch

from .reference import t5film


def make(cfg: dict, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    shapes = t5film.shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape in shapes.items():
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            std = t5film.init_std(name, cfg)
            if std is None:
                t.fill_(1.0)
            elif std == "xavier":
                t.mul_(math.sqrt(2.0 / (shape[0] + shape[1])))
            else:
                t.mul_(std)
            out[name] = t
    return out
