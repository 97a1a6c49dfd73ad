"""The yardstick's arithmetic: the H100's data-sheet peaks, the forward
FLOPs of the two model families counted from shapes, and the bytes and
operations of the hand-written kernels K2 (dropout) and K3 (Griffin-Lim
glue), each launch's least time being the larger of its bytes at the HBM
rate and its operations at their peak rates.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""
from __future__ import annotations

import functools

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense bfloat16
# int32 ALU: 64 lanes per SM against float32's 128, one op per lane-cycle
# against an FMA's two, so a quarter of the float32 FLOP rate
INT32_OPS_PER_S = F32_FLOPS_PER_S / 4
# Philox4x32-10 per element: ten rounds of two 32x32->64 multiplies and two
# three-input XORs over four words, then a compare and a select
PHILOX_INT_OPS_PER_ELEMENT = 10 * (2 + 2) / 4 + 2


def bound_s(n_bytes: float, n_flops: float = 0.0, n_int_ops: float = 0.0,
            n_bf16_flops: float = 0.0) -> float:
    """The least time of a launch: its bytes at the HBM rate or its
    operations at their peaks, whichever is longer."""
    t_ops = (n_flops / F32_FLOPS_PER_S + n_int_ops / INT32_OPS_PER_S
             + n_bf16_flops / BF16_FLOPS_PER_S)
    return max(n_bytes / HBM_BYTES_PER_S, t_ops)


def k3a_bound_s(nf: int, n_fft: int = 2048, hop: int = 256) -> float:
    """K3a (window, overlap-add, NOLA) over ``nf`` float32 frames: reads the
    frames, the window and the 1/window-sum-square blocks, writes y."""
    rows = nf + n_fft // hop - 1
    return bound_s(4 * (nf * n_fft + n_fft + 2 * rows * hop), rows * hop * (2 * 8 + 1))


def k3b_bound_s(nf: int, n_fft: int = 2048, hop: int = 256) -> float:
    """K3b (crop, reflect pad, re-frame, window): reads y and the window,
    writes the frames."""
    rows = nf + n_fft // hop - 1
    return bound_s(4 * (rows * hop + n_fft + nf * n_fft), nf * n_fft)


def k2_bound_s(numel: int, itemsize: int) -> float:
    """K2 (Philox mask applied): reads and writes each element once."""
    return bound_s(2 * numel * itemsize, numel, numel * PHILOX_INT_OPS_PER_ELEMENT)


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _meta_params(shapes: dict) -> dict:
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


@functools.lru_cache(maxsize=None)
def _pnet_flops(cfg_key: tuple, batch: int, frames: int) -> int:
    from .reference import nets

    cfg = dict(cfg_key)
    p = _meta_params(nets.performancenet_shapes(cfg))
    midi = torch.empty((batch, frames, cfg["start_channels"]), device="meta")
    spec = torch.empty((batch, frames, cfg["start_audio_channels"]), device="meta")
    return _count(lambda: nets.performancenet(p, cfg, midi, spec, midi))


@functools.lru_cache(maxsize=None)
def _ae_flops(cfg_key: tuple, batch: int, frames: int) -> int:
    from .reference import nets

    cfg = dict(cfg_key)
    p = _meta_params(nets.autoencoder_shapes(cfg))
    x = torch.empty((batch, frames, cfg["n_bins"]), device="meta")
    return _count(lambda: nets.autoencoder(p, cfg, x))


def _key(cfg: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()
                        if not isinstance(v, dict)))


def performancenet_forward_flops(cfg: dict, batch: int, frames: int = 860) -> int:
    """Convolution and matmul FLOPs (2 per multiply-add) of one forward."""
    return _pnet_flops(_key(cfg), batch, frames)


def autoencoder_forward_flops(cfg: dict, batch: int, frames: int = 860) -> int:
    return _ae_flops(_key(cfg), batch, frames)
