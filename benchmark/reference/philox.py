"""DenseConcat's dropout mask from its Philox4x32-10 bits, in plain PyTorch.

The mask of (seed, call_index) over a contiguous tensor of n elements:
element e keeps (scaled by 1/(1 - rate), rounded to float32) where word
e % 4 of Philox4x32-10 with counter (e // 4 as lo, hi; call_index; 0) and
key (seed lo, seed hi) is at most round((1 - rate) * 2^32) - 1.
"""
from __future__ import annotations

import torch

M = (0xD2511F53, 0xCD9E8D57)  # round multipliers (Random123)
W = (0x9E3779B9, 0xBB67AE85)  # key bumps
U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * m for int64 a in [0, 2^32)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = a_hi * m_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def bits(seed: int, call_index: int, n: int, device) -> torch.Tensor:
    """The uint32 words for elements 0..n-1, as int64."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1, c2, c3 = g & U32, g >> 32, torch.full_like(g, int(call_index)), torch.zeros_like(g)
    k0, k1 = int(seed) & U32, int(seed) >> 32
    for r in range(10):
        if r:
            k0, k1 = (k0 + W[0]) & U32, (k1 + W[1]) & U32
        hi0, lo0 = _mulhilo(c0, M[0])
        hi1, lo1 = _mulhilo(c2, M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:n]


def mask(seed: int, call_index: int, shape, rate: float, device) -> torch.Tensor:
    """The scaled float32 keep-mask of ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    threshold = max(min(int(round((1.0 - rate) * 2.0**32)), 2**32 - 1), 1) - 1
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    keep = bits(seed, call_index, n, device) <= threshold
    return (keep.to(torch.float32) * scale).reshape(shape)


def step_seeds(train_seed: int, n: int) -> list[int]:
    """The first ``n`` 64-bit dropout seeds of a run whose host generator is
    ``torch.Generator().manual_seed(train_seed)``: two uint32 draws each."""
    gen = torch.Generator().manual_seed(train_seed)
    out = []
    for _ in range(n):
        lo, hi = torch.randint(0, 2**32, (2,), generator=gen).tolist()
        out.append(lo | (hi << 32))
    return out
