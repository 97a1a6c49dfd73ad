"""Matmul DFT against the FFTs in the Griffin-Lim loop, per matmul
precision, on the card.

    python -m ml_music_style_transfer_tpu_torch.scripts.bench_dft_gl \\
        [--seconds 10] [--n-iter 300] [--json-out PATH] [--device cuda]

The port's counterpart of the JAX package's ``scripts/bench_dft_gl.py``.
For each way of computing the Griffin-Lim projection (frames, 2*bins)
[Re|Im] -> (frames, 2*bins), with the glue kernels between the two
transforms (``ops/kernels/gl_glue.gl_consistency_frames``, their plain
version on the CPU), it prints:

  1. the time per iteration of the momentum loop, the slope between runs
     of 10 and 40 iterations on the host clock, each ended by a device
     sync (least of 3 runs each);
  2. the spectral convergence, ||stft(y)| - mag| / |mag|, after
     ``--n-iter`` iterations from one seeded phase on a synthetic harmonic
     clip of ``--seconds`` (``testing/synthetic.py``, the "cuba" timbre).

The variants: "fft" (``torch.fft.irfft``/``rfft``, cuFFT on the card);
"dft_bf16" (one matmul per direction against the exact one-sided DFT
pair, bfloat16 inputs and float32 accumulation and output: the port's
``transform="dft"``); "dft_tf32" (float32 inputs, TF32 tensor cores);
"dft_f32" (float32, TF32 off). The DFT pair, for real frames x (N =
n_fft, bins = N/2 + 1, w_k = 1 at k = 0 and N/2, else 2):

    rfft:  [Re X | Im X] = x @ [cos(2 pi n k / N) | -sin(2 pi n k / N)]
    irfft: x = [Re X | Im X] @ [[w_k cos / N], [-w_k sin / N]]

The script keeps its own projection functions, as the JAX script does;
the package has no precision option. ``--device cpu`` checks the script
(TF32 is the CPU's float32 there; the bfloat16 variant rounds its inputs
to bfloat16 and multiplies in float32); its numbers are CPU numbers.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import stft as tstft
from ..ops.kernels import gl_glue
from ..testing import synthetic
from .bench_inference import smi_line, sync

N_FFT, HOP = 2048, 256
BINS = N_FFT // 2 + 1
MOMENTUM = 0.99
EPS = 1.1754944e-38
ITERS = (10, 40)  # the slope's two run lengths


def make_project(name: str, n_frames: int, dev: torch.device):
    """The projection (frames, 2*bins) -> (frames, 2*bins) of ``name``
    and the TF32 setting it runs under."""
    window = tstft.window_tensor(N_FFT, N_FFT, dev)
    inv_blocks = tstft.wss_inv_tensor(N_FFT, N_FFT, HOP, n_frames, dev).view(
        n_frames + N_FFT // HOP - 1, HOP)

    def glue(frames):
        return gl_glue.gl_consistency_frames(frames.contiguous(), window, inv_blocks)

    if name == "fft":
        def project(reim, mag_t):
            spec = torch.complex(reim[:, :BINS] * mag_t, reim[:, BINS:] * mag_t)
            reb = torch.fft.rfft(glue(torch.fft.irfft(spec, n=N_FFT, dim=-1)), dim=-1)
            return torch.cat([reb.real, reb.imag], dim=-1)
        return project, False

    dtype = torch.bfloat16 if name == "dft_bf16" else torch.float32
    fwd, inv = tstft.dft_matrices(N_FFT, dtype, dev)

    def matmul(a, b):
        if dtype == torch.float32:
            return torch.mm(a, b)
        if dev.type == "cuda":  # bfloat16 in, float32 accumulation and out
            return torch.mm(a.to(dtype), b, out_dtype=torch.float32)
        return torch.mm(a.to(dtype).float(), b.float())

    def project(reim, mag_t):
        spec = torch.cat([reim[:, :BINS] * mag_t, reim[:, BINS:] * mag_t], dim=-1)
        return matmul(glue(matmul(spec, inv)), fwd)
    return project, name == "dft_tf32"


def gl_run(project, mag_t, phase0, n_iter: int) -> torch.Tensor:
    """Momentum Griffin-Lim on the packed [Re|Im] state; the waveform."""
    mom = MOMENTUM / (1.0 + MOMENTUM)
    ang = torch.cat([torch.cos(phase0), torch.sin(phase0)], dim=-1)
    reb = torch.zeros_like(ang)
    for _ in range(n_iter):
        reb_new = project(ang, mag_t)
        a = reb_new - mom * reb
        norm = torch.sqrt(a[:, :BINS] ** 2 + a[:, BINS:] ** 2) + EPS
        ang, reb = torch.cat([a[:, :BINS] / norm, a[:, BINS:] / norm], dim=-1), reb_new
    spec = torch.complex(ang[:, :BINS] * mag_t, ang[:, BINS:] * mag_t)
    return tstft.istft(spec.transpose(0, 1), HOP, N_FFT)


def seconds_per_iter(run, dev: torch.device) -> float:
    """Slope of the least of 3 host-clock times of ``run(n)``, each ended
    by a device sync, between the two run lengths of ``ITERS``."""
    best = {}
    for n in ITERS:
        times = []
        for _ in range(3):
            sync(dev)
            t = time.perf_counter()
            run(n)
            sync(dev)
            times.append(time.perf_counter() - t)
        best[n] = min(times)
    lo, hi = ITERS
    return (best[hi] - best[lo]) / (hi - lo)


def spectral_error(wave: torch.Tensor, mag: torch.Tensor) -> float:
    reb = tstft.stft(wave, N_FFT, HOP).abs()[:, : mag.shape[1]]
    return float(torch.linalg.vector_norm(reb - mag) / torch.linalg.vector_norm(mag))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--n-iter", type=int, default=300)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = smi_line() if dev.type == "cuda" else "cpu"
    print(where, flush=True)
    notes = synthetic.random_song(np.random.default_rng(1), duration=args.seconds)
    wave = synthetic.render_notes(notes, style="cuba", duration=args.seconds)
    mag = tstft.stft(tstft.to_device(wave.astype(np.float32), dev), N_FFT, HOP).abs()
    mag_t = mag.transpose(0, 1).contiguous()  # (frames, bins)
    n_frames = mag_t.shape[0]
    phase0 = tstft.to_device(np.random.default_rng(0).uniform(
        0, 2 * np.pi, (n_frames, BINS)).astype(np.float32), dev)
    results = {"n_frames": n_frames, "n_iter": args.n_iter, "seconds": args.seconds,
               "device": where, "torch": torch.__version__}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for name in ("fft", "dft_bf16", "dft_tf32", "dft_f32"):
            project, use_tf32 = make_project(name, n_frames, dev)
            torch.backends.cuda.matmul.allow_tf32 = use_tf32
            with torch.inference_mode():
                gl_run(project, mag_t, phase0, 2)  # warm-up
                s = seconds_per_iter(lambda n: gl_run(project, mag_t, phase0, n), dev)
                err = spectral_error(gl_run(project, mag_t, phase0, args.n_iter), mag)
            results[name] = {"us_per_iter": s * 1e6, "spectral_err": err}
            print(f"{name:9s}: {s * 1e6:9.2f} us/iter   spectral_err@{args.n_iter} = {err:.5f}",
                  flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    base = results["fft"]
    for name in ("dft_bf16", "dft_tf32", "dft_f32"):
        r = results[name]
        r["fft_over_this"] = base["us_per_iter"] / r["us_per_iter"]
        print(f"{name}: {r['fft_over_this']:.2f}x the fft loop's iteration rate, err "
              f"{r['spectral_err']:.5f} vs fft {base['spectral_err']:.5f}", flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
