"""DenseConcat dropout: the Philox CUDA kernel's wrappers and plain versions.

Replaces the JAX package's Pallas kernel ``_mask_kernel``
(``ml_music_style_transfer_tpu/ops/pallas/dropout.py:37``, ``pallas_call``
at :94): a scaled keep-mask, ``1/(1-rate)`` where the random uint32 bits
are ``<= keep_threshold(rate)``, else 0, in the activation dtype. The JAX
model multiplies activations by it (``models/layers.py:64-66``).

The TPU draws its bits from its hardware PRNG; the card has none, so the
kernel (``csrc/dropout.cu``, design and bound in its header) computes
Philox4x32-10 with key = the 64-bit seed as (lo, hi) and counter =
(element // 4 as lo, hi; ``call_index``; 0). The bits depend only on
(seed, call_index, element index), so the plain versions here compute the
same bits with PyTorch integer ops and the kernel matches them bit for bit.

Entry points, on contiguous float32 or bfloat16 tensors:
  - ``dropout_mask``: the mask itself, what the TPU kernel computes;
  - ``dropout_apply``: ``x * mask`` in one pass, the mask never stored;
  - ``dropout_grad``: the same kernel on the incoming gradient, for the
    backward (it regenerates the mask from the seed instead of saving it);
  - ``dropout``: ``x * mask`` with that backward (the model's dropout).
Each calls an operator of ``csrc/mmst_ops.cpp``: ``mmst_torch::dropout_mask``
or ``mmst_torch::dropout_apply`` (``backward=True`` for the gradient; its
autograd formula is attached in ``_library.py``). On a CUDA tensor the
operator launches the kernel or raises; on a CPU tensor it runs the plain
version, there in C++ (which also takes float64, for ``gradcheck``).
``LAUNCHES`` reads the library's count of CUDA launches per entry point.
"""
from __future__ import annotations

import torch

from . import _library

LAUNCHES = _library.LaunchCounts("dropout_mask", "dropout_apply", "dropout_grad")

PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers (Random123)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key bumps
_U32 = 0xFFFFFFFF
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def reset_launches() -> None:
    LAUNCHES.reset()


def fold_seed(seed: int, k: int) -> int:
    """A 64-bit seed for rank ``k`` of a mesh axis, derived from ``seed``:
    ``seed`` itself for k = 0 (so rank 0 of any mesh draws the masks of one
    device), else splitmix64 of ``seed + k * golden ratio``. The Philox
    bits depend only on (seed, call_index, element), so ranks that must draw
    different masks (data ranks; the model ranks of a column-parallel
    output) fold their index in."""
    if k == 0:
        return int(seed) % 2**64
    z = (int(seed) + int(k) * 0x9E3779B97F4A7C15) % 2**64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
    return z ^ (z >> 31)


def keep_threshold(rate: float) -> int:
    """uint32 keep threshold: keep iff bits <= threshold (the JAX kernel's
    ``_keep_threshold``, dropout.py:52-60). Clamped below at 0, so a keep
    probability under 2^-33 keeps almost nothing instead of wrapping to
    uint32 max, and above at 2^32 - 2."""
    keep = 1.0 - rate
    return max(min(int(round(keep * 2.0**32)), 2**32 - 1), 1) - 1


def _scale(rate: float, dtype: torch.dtype) -> torch.Tensor:
    """1/(1-rate) rounded to float32, then to ``dtype``, as the JAX kernel
    stores it (dropout.py:44-45)."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).to(dtype)


def _check_args(seed: int, call_index: int, rate: float) -> None:
    if not 0 <= int(seed) < 2**64:
        raise ValueError(f"seed must be a 64-bit unsigned integer, got {seed}")
    if not 0 <= int(call_index) < 2**32:
        raise ValueError(f"call_index must be a 32-bit unsigned integer, got {call_index}")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1), got {rate}")


# ---- plain versions ---------------------------------------------------------

def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32),
    from 16-bit halves so that no int64 product overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = a_hi * m_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key: tuple[int, int]):
    """Philox4x32-10 on int64 tensors holding uint32 words: ``counter`` is
    four broadcastable tensors, ``key`` two ints; returns four tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _U32, (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_bits(seed: int, call_index: int, n: int, device="cpu") -> torch.Tensor:
    """The kernel's uint32 bits for elements 0..n-1, as int64 (n,)."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(
        (g & _U32, g >> 32, torch.full_like(g, int(call_index)), torch.zeros_like(g)),
        (int(seed) & _U32, int(seed) >> 32))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def dropout_mask_reference(seed: int, call_index: int, shape, rate: float,
                           dtype: torch.dtype = torch.bfloat16, device="cpu") -> torch.Tensor:
    """Plain PyTorch mask: 1/(1-rate) where the Philox bits <= threshold."""
    _check_args(seed, call_index, rate)
    n = 1
    for d in shape:
        n *= int(d)
    keep = random_bits(seed, call_index, n, device) <= keep_threshold(rate)
    scale = _scale(rate, dtype).to(device)
    return torch.where(keep, scale, torch.zeros((), dtype=dtype, device=device)).reshape(shape)


def dropout_apply_reference(x: torch.Tensor, seed: int, call_index: int,
                            rate: float) -> torch.Tensor:
    """Plain PyTorch ``x * mask``."""
    return x * dropout_mask_reference(seed, call_index, x.shape, rate, x.dtype, x.device)


# ---- wrappers ---------------------------------------------------------------

def _check_device(device: torch.device, dtype: torch.dtype) -> None:
    if device.type == "cuda":
        if dtype not in _KERNEL_DTYPES:
            raise TypeError(f"the dropout kernel takes float32 or bfloat16, got {dtype}")
    elif device.type == "cpu":
        if dtype not in _PLAIN_DTYPES:
            raise TypeError(f"dropout takes float32, bfloat16 or float64, got {dtype}")
    else:
        raise ValueError(f"unsupported device {device}")


def _signed(seed: int) -> int:
    """The unsigned 64-bit seed as the schema's signed ``int`` (its two's
    complement); the operators take it back as unsigned."""
    seed = int(seed)
    return seed - 2**64 if seed >= 2**63 else seed


def dropout_mask(seed: int, call_index: int, shape, rate: float,
                 dtype: torch.dtype = torch.bfloat16, device="cuda") -> torch.Tensor:
    """Scaled keep-mask of ``shape`` on ``device``: 1/(1-rate) with
    probability about 1-rate, else 0."""
    _check_args(seed, call_index, rate)
    device = torch.device(device)
    _check_device(device, dtype)
    return _library.ops().dropout_mask([int(d) for d in shape], _signed(seed), int(call_index),
                                       float(rate), dtype, device)


def _apply(x: torch.Tensor, seed: int, call_index: int, rate: float, entry: str) -> torch.Tensor:
    _check_args(seed, call_index, rate)
    _check_device(x.device, x.dtype)
    if not x.is_contiguous():
        raise ValueError(f"{entry} needs a contiguous tensor")
    return _library.ops().dropout_apply(x, _signed(seed), int(call_index), float(rate),
                                        entry == "dropout_grad")


def dropout_apply(x: torch.Tensor, seed: int, call_index: int, rate: float) -> torch.Tensor:
    """``x * dropout_mask(seed, call_index, x.shape, rate, x.dtype)`` in one pass."""
    return _apply(x, seed, call_index, rate, "dropout_apply")


def dropout_grad(grad: torch.Tensor, seed: int, call_index: int, rate: float) -> torch.Tensor:
    """The backward of ``dropout_apply``: ``grad * mask``, the same kernel
    regenerating the forward's mask."""
    return _apply(grad, seed, call_index, rate, "dropout_grad")


def dropout(x: torch.Tensor, seed: int, call_index: int, rate: float) -> torch.Tensor:
    """``x * mask`` with a gradient of ``grad * mask``, through the
    ``mmst_torch::dropout_apply`` operator; ``seed`` is unsigned 64-bit."""
    return _library.ops().dropout_apply(x, _signed(seed), call_index, rate, False)
