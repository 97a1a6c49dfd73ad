"""Fused Conv1x3 -> InstanceNorm -> LeakyReLU: the CUDA kernel's wrapper and
plain versions, and the model's conv-block shapes.

Replaces the JAX package's Pallas kernel ``_kernel``
(``ml_music_style_transfer_tpu/ops/pallas/fused_conv.py:42``, ``pallas_call``
at :117): ``LReLU(InstanceNorm_T(conv1d(x, w, padding=1) + b))`` on
channel-last activations, float32 accumulation and statistics. The kernel
is ``csrc/fused_conv.cu`` (design and bound in its header): a conv GEMM
(bfloat16: wgmma fed by TMA) that writes y to a float32 workspace and each
64-row box's partial statistics, then one normalisation pass that merges
them; two launches behind one C entry point, called by the operator
``mmst_torch::conv1x3_instnorm_lrelu`` (``csrc/mmst_ops.cpp``, which also
pads and aligns the operands as TMA needs). ``LAUNCHES`` reads the
library's count, one per call that launches them.
``instnorm_stats_boxed`` is the plain version of that reduction.

As in the JAX package, the model does not call it: the port's model keeps
``F.conv1d`` -> ``instance_norm`` -> ``leaky_relu`` (``models/layers.py``),
as the JAX model keeps XLA's conv. Its entry point is the benchmark
``scripts/bench_fused_conv.py``, at the shapes ``model_layer_shapes``
gives. It is forward-only, as in JAX: the wrapper refuses inputs that
require grad while grad mode is on, since no gradient would flow back.

On a CUDA tensor the operator launches the kernel or raises; on a CPU
tensor it runs the plain version, there in ATen op for op.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import _library

LAUNCHES = _library.LaunchCounts("conv1x3_instnorm_lrelu")

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
BOX = 64  # time rows of one item per GEMM box (csrc/fused_conv.cu kBox)


def reset_launches() -> None:
    LAUNCHES.reset()


# ---- plain version ----------------------------------------------------------

def conv1x3_instnorm_lrelu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                     eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch, the JAX reference's math (fused_conv.py:137-147): w is
    cast to x's dtype, then x and w to float32 (exact for bfloat16); the
    zero time-padded three-tap sum plus the float32 bias; population mean
    and variance over T; LeakyReLU; one cast to x's dtype at the end."""
    T = x.shape[1]
    x32 = F.pad(x.to(torch.float32), (0, 0, 1, 1))
    w32 = w.to(x.dtype).to(torch.float32)
    y = b.to(torch.float32) + sum(x32[:, d : d + T] @ w32[d] for d in range(3))
    mean = y.mean(dim=1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=1, keepdim=True)
    yn = (y - mean) * torch.rsqrt(var + eps)
    return torch.where(yn >= 0, yn, slope * yn).to(x.dtype)


def instnorm_stats_boxed(y: torch.Tensor, box: int = BOX) -> tuple[torch.Tensor, torch.Tensor]:
    """Population mean and variance over T of y (B, T, C), reduced as the
    kernel reduces them, in y's dtype: each item's rows cut into boxes of
    ``box`` (the last ragged), each box's mean and M2 = sum (y - box mean)^2
    in two passes, then the boxes merged in order by Chan's formula
    (n = na + nb, delta = mean_b - mean_a, mean += delta nb / n,
    M2 += M2_b + delta^2 na nb / n). Returns (mean, var), each (B, C)."""
    T = y.shape[1]
    cnt = 0.0
    mean = m2 = torch.zeros((y.shape[0], y.shape[2]), dtype=y.dtype, device=y.device)
    for t0 in range(0, T, box):
        yb = y[:, t0 : t0 + box]
        nb = yb.shape[1]
        bm = yb.sum(dim=1) / nb
        bq = ((yb - bm[:, None]) ** 2).sum(dim=1)
        tot = cnt + nb
        delta = bm - mean
        mean = mean + delta * (nb / tot)
        m2 = m2 + bq + delta * delta * (cnt * nb / tot)
        cnt = tot
    return mean, m2 / T


def gemm_ctas(batch: int, t: int, cout: int, dtype: torch.dtype) -> int:
    """CTAs of the GEMM launch the kernel makes for (B, T, Cout) in
    ``dtype`` on the current card: bfloat16, two 64-row boxes by a tile of
    256, 192 or 128 output channels, the width picked from the card's SM
    count (``csrc/fused_conv.cu`` ``tile_n``); float32, one box by 64.
    Needs the operator library built with CUDA."""
    return _library.ops().conv1x3_instnorm_lrelu_ctas(batch, t, cout, dtype)


# ---- wrapper ----------------------------------------------------------------

def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, Cin), got shape {tuple(x.shape)}")
    cin = x.shape[2]
    if w.dim() != 3 or w.shape[0] != 3 or w.shape[1] != cin:
        raise ValueError(f"w must be (3, {cin}, Cout), got shape {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[2],):
        raise ValueError(f"b must be ({w.shape[2]},), got shape {tuple(b.shape)}")
    if not (w.is_floating_point() and b.is_floating_point()):
        raise TypeError("w and b must be floating point")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"x, w and b must be on one device, got {x.device}, {w.device}, "
                         f"{b.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        raise RuntimeError("conv1x3_instnorm_lrelu is forward-only (as the JAX kernel); "
                           "call it under torch.no_grad() or on tensors that need no grad")


def conv1x3_instnorm_lrelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """LeakyReLU(InstanceNorm_T(conv1x3(x))) in one call.

    x: (B, T, Cin) float32 or bfloat16, contiguous; w: (3, Cin, Cout), cast
    to x's dtype (torch Conv1d k=3 s=1 p=1 semantics); b: (Cout,), which
    the plain version adds in float32 and the kernel leaves out, since the
    InstanceNorm cancels it. Returns (B, T, Cout) in x's dtype. The JAX
    wrapper's ``block_b`` and ``interpret`` arguments pick a TPU tiling and
    the TPU interpreter; they have no counterpart here.
    """
    _check(x, w, b)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return _library.ops().conv1x3_instnorm_lrelu(x, w, b, float(eps), float(slope))


# ---- the model's conv blocks ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvBlock:
    """One conv1x3 -> InstanceNorm -> LeakyReLU of the model: its module
    path, the (B, T, Cin) -> Cout it computes, and how often a forward runs
    it (an MBR ``conv_list1`` runs once per band)."""

    name: str
    batch: int
    t: int
    cin: int
    cout: int
    launches: int = 1

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return (self.batch, self.t, self.cin, self.cout)


def model_layer_shapes(cfg, batch: int) -> list[ConvBlock]:
    """Every conv1x3 -> InstanceNorm -> LeakyReLU of PerformanceNet(cfg) at
    ``batch``, in forward order, from the config's channel plans and the
    temporal ladder: both convs of each MIDI, audio and onset DownConv, both
    convs of each UpConv, and each MBR block's ``conv_list1`` (its
    ``conv_list2`` has no LeakyReLU; the ConvTranspose layers are no
    conv1x3). At full width that is 38 blocks, 64 launches."""
    from ...models.performance_net import temporal_ladder

    ladder = temporal_ladder(depth=cfg.depth)
    enc, dec = ladder["encoder"], ladder["decoder"]
    midi, audio = cfg.midi_channel_plan, cfg.audio_channel_plan
    onoff = [cfg.scaled(cfg.start_channels * 2 ** (i + 1))
             for i in range(cfg.onset_encoder_depth)]
    blocks: list[ConvBlock] = []

    def downs(prefix: str, cin: int, plan) -> None:
        for i, cout in enumerate(plan):
            blocks.append(ConvBlock(f"{prefix}.{i}.conv1", batch, enc[i], cin, cout))
            blocks.append(ConvBlock(f"{prefix}.{i}.conv2", batch, enc[i], cout, cout))
            cin = cout

    downs("down_convs", cfg.start_channels, midi)
    downs("down_convs_audio", cfg.start_audio_channels, audio)
    downs("onset_offset_encoder.down_convs", cfg.start_channels, onoff)
    # (out, skip, condition) channels of each UpConv, as PerformanceNet wires
    # them: the skip is that level's DenseConcat output, the conditions the
    # onset encoder's last two maps, deepest first
    ups = [(midi[3], midi[3], onoff[-1]), (midi[2], midi[2], onoff[-2]),
           (midi[2], midi[1], 0), (midi[2], midi[0], 0)]
    for i, (out, skip, cond) in enumerate(ups):
        blocks.append(ConvBlock(f"up_convs.{i}.conv1", batch, dec[i + 1], out + skip, out))
        blocks.append(ConvBlock(f"up_convs.{i}.conv2", batch, dec[i + 1], out + cond, out))
    if not cfg.compat_mbr_noop:
        for j, bands in enumerate((2, 4, 8, 16), start=1):
            c = midi[2] // bands
            blocks.append(ConvBlock(f"MBRBlock{j}.conv_list1", batch, dec[-1], c, c, bands))
    return blocks
