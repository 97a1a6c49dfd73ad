"""Benchmark the fused Conv1x3 -> InstanceNorm -> LeakyReLU kernel on the card.

    python -m ml_music_style_transfer_tpu_torch.scripts.bench_fused_conv [--all-model-shapes]

Counterpart of the JAX package's ``scripts/bench_pallas.py``: the same four
default shapes (audio L0, L1, L4 and midi L0 at batch 16, bfloat16) and the
same seeded inputs (numpy ``default_rng(0)``: x ~ N(0, 1), w ~ N(0, 1) /
sqrt(3 Cin), b ~ N(0, 1)). ``--all-model-shapes`` runs every distinct shape
of ``model_layer_shapes`` (the full-width model at batch 16) instead, and
ends with the launch-weighted total over one forward's conv blocks.

Per shape it prints the kernel's time, its plain version's, the cuDNN
composite's (``F.conv1d`` -> ``F.instance_norm`` -> ``F.leaky_relu`` on
(B, C, T) tensors, as the port's model runs the block), the composite's
time over the kernel's, the kernel's max abs error against its plain
version, the CTAs its GEMM launches (``fused_conv.gemm_ctas``; an H100
SXM has 132 SMs, one CTA each), and the share of its bound that the
kernel reaches (bound: the larger of the function's bytes over the HBM
rate and its FLOPs over the tensor cores' bfloat16 or the float32 rate;
H100 SXM data-sheet rates).
Times are CUDA-event means over back-to-back launches. It needs a card.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.kernels import fused_conv as fc

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12    # H100 SXM tensor cores, dense bfloat16
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
NORM_FLOPS_PER_OUTPUT = 8    # bias, mean, centre, square-add, scale, LeakyReLU
SPIN_CYCLES = 100_000_000    # about 50 ms at the H100's boost clock

SHAPES = [  # (B, T, Cin, Cout, tag), as scripts/bench_pallas.py
    (16, 860, 1025, 1536, "audio L0"),
    (16, 430, 1536, 2048, "audio L1"),
    (16, 53, 4096, 6144, "audio L4"),
    (16, 860, 128, 256, "midi L0"),
]


def numpy_inputs(rng: np.random.Generator, B: int, T: int, cin: int, cout: int,
                 device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, w in bfloat16 and b in float32, drawn as bench_pallas.py draws them."""
    x = torch.from_numpy(rng.standard_normal((B, T, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, cin, cout)) / np.sqrt(3 * cin)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return x.to(device, torch.bfloat16), w.to(device, torch.bfloat16), b.to(device)


def block_work(B: int, T: int, cin: int, cout: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(bytes, GEMM FLOPs, float32 FLOPs of the normalisation) of one call:
    x, w, b read once and out written once."""
    item = torch.tensor([], dtype=dtype).element_size()
    n_bytes = item * (B * T * cin + 3 * cin * cout + B * T * cout) + 4 * cout
    return n_bytes, 6 * B * T * cin * cout, NORM_FLOPS_PER_OUTPUT * B * T * cout


def bound_ms(B: int, T: int, cin: int, cout: int, dtype: torch.dtype) -> tuple[float, str]:
    n_bytes, gemm, norm = block_work(B, T, cin, cout, dtype)
    gemm_rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = gemm / gemm_rate + norm / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cudnn_composite(x_nct: torch.Tensor, w_oik: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The block as library calls on (B, C, T): the yardstick, not the port."""
    return F.leaky_relu(F.instance_norm(F.conv1d(x_nct, w_oik, b, padding=1)), 0.01)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls (CUDA events);
    the card spins first while the host queues the calls, so the events time
    the kernels and not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def reps_for(B: int, T: int, cin: int, cout: int) -> int:
    """Back-to-back calls to time: about 20 GFLOP of work, 3 to 50 calls."""
    return max(3, min(50, math.ceil(2e10 / (6 * B * T * cin * cout))))


def measure(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> dict:
    """The kernel's, plain version's and cuDNN composite's times at one
    shape, the kernel's max abs error against the plain version (taken
    before anything is timed), and the bound."""
    B, T, cin = x.shape
    cout = w.shape[2]
    n = reps_for(B, T, cin, cout)
    got = fc.conv1x3_instnorm_lrelu(x, w, b)
    want = fc.conv1x3_instnorm_lrelu_reference(x, w, b)
    err = float((got.float() - want.float()).abs().max())
    del got, want
    x_nct = x.transpose(1, 2).contiguous()
    w_oik = w.permute(2, 1, 0).contiguous()
    b_lib = b.to(x.dtype)
    bound = bound_ms(B, T, cin, cout, x.dtype)
    return dict(
        ms=cuda_ms(lambda: fc.conv1x3_instnorm_lrelu(x, w, b), n),
        plain_ms=cuda_ms(lambda: fc.conv1x3_instnorm_lrelu_reference(x, w, b),
                         max(2, n // 4), warmup=1),
        library_ms=cuda_ms(lambda: cudnn_composite(x_nct, w_oik, b_lib), n),
        max_abs_err=err, bound_ms=bound[0], bound_by=bound[1],
        ctas=fc.gemm_ctas(B, T, cout, x.dtype))


def row_line(tag: str, r: dict) -> str:
    return (f"{tag}: kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
            f"cuDNN composite {r['library_ms']:.4f} ms | cuDNN/kernel "
            f"{r['library_ms'] / r['ms']:.2f}x | maxerr {r['max_abs_err']:.4g} | "
            f"{r['ctas']} CTAs | {100 * r['bound_ms'] / r['ms']:.1f} % of bound "
            f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")


def weighted_total(blocks, rows: dict) -> dict:
    """Launch-weighted sums over ``blocks`` of the per-shape times in ``rows``
    (keyed by ``ConvBlock.shape``)."""
    return {k: sum(blk.launches * rows[blk.shape][k] for blk in blocks)
            for k in ("ms", "library_ms", "bound_ms")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--all-model-shapes", action="store_true",
                   help="every distinct conv-block shape of the full-width model")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark times the CUDA kernel: it needs an NVIDIA GPU")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in float32
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {torch.cuda.get_device_name(device)}, bfloat16, batch 16")

    if args.all_model_shapes:
        blocks = fc.model_layer_shapes(ModelConfig(), 16)
        tags = {}
        for blk in blocks:
            tags.setdefault(blk.shape, []).append(blk.name)
        shapes = [(*shape, " ".join(names)) for shape, names in tags.items()]
    else:
        blocks = None
        shapes = SHAPES
    rng = np.random.default_rng(0)
    rows = {}
    for B, T, cin, cout, tag in shapes:
        x, w, b = numpy_inputs(rng, B, T, cin, cout, device)
        with torch.no_grad():
            rows[(B, T, cin, cout)] = r = measure(x, w, b)
        print(row_line(f"{tag} ({cin}->{cout} @T{T})", r), flush=True)
        del x, w, b
    if blocks is not None:
        tot = weighted_total(blocks, rows)
        print(f"one forward's {sum(blk.launches for blk in blocks)} conv blocks: kernel "
              f"{tot['ms']:.3f} ms | cuDNN composite {tot['library_ms']:.3f} ms | bound "
              f"{tot['bound_ms']:.3f} ms")
    return rows


if __name__ == "__main__":
    main()
