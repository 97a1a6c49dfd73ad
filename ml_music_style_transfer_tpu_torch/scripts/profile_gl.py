"""Griffin-Lim cost breakdown: the counterpart of the root
``scripts/profile_gl.py``.

Per iteration of the serving loop (``ops/griffinlim.gl_steps`` with the
glue kernels) at the 2150-frame bucket of a 10 s clip, it times:
  - the full iteration;
  - the irfft alone and the rfft alone, at the loop's shapes;
  - the consistency glue alone (``gl_glue.gl_consistency_frames``: the
    K3a overlap-add and K3b re-framing kernels on the card, their plain
    version on the CPU);
  - the momentum update's elementwise passes alone (magnitude times
    angles, ``rebuilt - mom * prev``, the renormalisation);
  - and what is left of the iteration beyond those four.

Each time is the mean of ``--n-iter`` iterations between CUDA events (the
full iteration: one loop of ``--n-iter``, after one untimed loop; each
part: ``--n-iter`` calls after ``--warmup``), by the host clock on the CPU,
where ``--device cpu`` checks the script. It prints the card's name and
power limit first, one ``metric`` line per time, then one JSON object.

    python -m ml_music_style_transfer_tpu_torch.scripts.profile_gl \
        [--frames 2150] [--n-iter 100] [--warmup 10]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops import griffinlim as gl
from ..ops import stft
from ..ops.kernels import gl_glue
from .bench_inference import metric_line, smi_line
from .profile_step import mean_ms

N_FFT, HOP = 2048, 256
MOMENTUM = 0.99


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=2150,
                    help="STFT frames (2150: a 10 s clip's bucket)")
    ap.add_argument("--n-iter", type=int, default=100, help="timed iterations")
    ap.add_argument("--warmup", type=int, default=10, help="untimed iterations first")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(smi_line(), flush=True)
    n, bins = args.frames, N_FFT // 2 + 1
    rng = np.random.default_rng(0)
    mag = torch.from_numpy(np.abs(rng.standard_normal((bins, n))).astype(np.float32)).to(dev)
    phase = torch.from_numpy(rng.uniform(0, 2 * np.pi, (bins, n)).astype(np.float32)).to(dev)
    angles = torch.polar(torch.ones_like(phase), phase)
    carry = (angles, torch.zeros_like(angles))
    window = stft.window_tensor(N_FFT, N_FFT, dev)
    inv_blocks = gl._inv_blocks(N_FFT, HOP, n, dev)
    # the loop's frame-major operands
    mag_t = mag.transpose(0, 1).contiguous()
    ang_t = angles.transpose(0, 1).contiguous()
    frames = torch.fft.irfft(mag_t * ang_t, n=N_FFT, dim=-1)
    spec_t = torch.fft.rfft(frames, dim=-1)
    mom = MOMENTUM / (1.0 + MOMENTUM)

    def full():  # the serving loop, n_iter iterations in one call
        return gl.gl_steps(mag, carry, args.n_iter, HOP, N_FFT, MOMENTUM)

    mag_r, ang_r, spec_r = mag_t.unsqueeze(-1), torch.view_as_real(ang_t), torch.view_as_real(spec_t)

    def elementwise():  # the loop's real-valued passes (griffinlim._gl_steps_real)
        return gl._momentum_update(spec_r, mag_r * ang_r, mom)

    parts = {
        "irfft": lambda: torch.fft.irfft(spec_t, n=N_FFT, dim=-1),
        "rfft": lambda: torch.fft.rfft(frames, dim=-1),
        "glue": lambda: gl_glue.gl_consistency_frames(frames, window, inv_blocks),
        "momentum_elementwise": elementwise,
    }
    extra = dict(frames=n, n_fft=N_FFT, hop=HOP, n_iter=args.n_iter)
    metrics = {}

    def report(name, ms, **more):
        metrics[name] = ms
        print(metric_line(name, ms, "ms", dev, **extra, **more), flush=True)

    with torch.no_grad():
        t_full = mean_ms(full, dev, 1, 1) / args.n_iter
        times = {k: mean_ms(fn, dev, args.n_iter, args.warmup) for k, fn in parts.items()}
    report("gl_iteration_ms", t_full)
    for name, ms in times.items():
        report(f"gl_{name}_ms", ms, share=round(ms / t_full, 4))
    rest = t_full - sum(times.values())
    report("gl_rest_ms", rest, share=round(rest / t_full, 4))
    print(json.dumps({"metrics": metrics, "device": str(dev),
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}))
    return metrics


if __name__ == "__main__":
    main()
