#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Imports only the port (``ml_music_style_transfer_tpu_torch``), torch, numpy,
scipy and the standard library. Phases, each reported on its own lines:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for every float32 comparison below;
  2. build: compile the CUDA kernels from ``ml_music_style_transfer_tpu_torch/csrc``;
  3. kernels vs plain: the Griffin-Lim glue kernels against their plain
     PyTorch versions on the card at nf = 100 and at the 30 s serving shape
     nf = 5160 (max abs error <= 1e-4), rfft(glue(irfft S)) against
     stft(istft S) (<= 1e-3), and each kernel's time beside its plain
     version's and its memory bound;
  4. main path: a full-width PerformanceNet (731,945,857 params, bfloat16
     compute, seeded random weights) serves three requests (10 s, 30 s and
     30 s of MIDI, timbre clips of 6 s, 30 s and 27.5 s) through
     ``AudioSynthesizer.inference`` with 300 Griffin-Lim iterations; each
     waveform is checked and each request must launch each glue kernel 300
     times. Then Griffin-Lim through the kernels is held against the plain
     path on the first request's spectrogram;
  5. profile: the Griffin-Lim loop's wall time per iteration, device time
     by kernel (torch.profiler) and device busy share on the warm
     request's spectrogram.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero, and
without a card the script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
FULL_WIDTH_PARAMS = 731_945_857
N_ITER = 300
REQUESTS = ((10.0, 6.0), (30.0, 30.0), (30.0, 27.5))  # (MIDI s, timbre WAV s)
GL_BUCKET = 430  # Griffin-Lim runs over the MIDI's frames rounded up to half a chunk


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---- phase 3: kernels vs plain ---------------------------------------------

def kernel_phase(torch, glue, tstft):
    n_fft, hop = 2048, 256
    errs = {"gl_ola_nola": 0.0, "gl_frame_window": 0.0}
    timing = {}
    for nf in (100, 5160):
        gen = torch.Generator().manual_seed(nf)
        frames = torch.randn((nf, n_fft), generator=gen).cuda()
        window = torch.from_numpy(tstft.window_const(n_fft, n_fft)).cuda()
        inv = torch.from_numpy(tstft.wss_inv_const(n_fft, n_fft, hop, nf).reshape(
            nf + 7, hop)).cuda()
        # kernels first: no plain result can sit in a freed block they reuse
        y_kern = glue.ola_nola(frames, window, inv)
        g_full = glue.gl_consistency_frames(frames, window, inv)
        y_plain = glue.ola_nola_reference(frames, window, inv)
        g_kern = glue.frame_window(y_plain, window, nf)
        g_plain = glue.frame_window_reference(y_plain, window, nf)
        full_err = float((g_full - glue.gl_consistency_frames_reference(
            frames, window, inv)).abs().max())
        torch.cuda.synchronize()
        e_ola = float((y_kern - y_plain).abs().max())
        e_frame = float((g_kern - g_plain).abs().max())
        errs["gl_ola_nola"] = max(errs["gl_ola_nola"], e_ola)
        errs["gl_frame_window"] = max(errs["gl_frame_window"], e_frame)
        print(f"kernel nf={nf}: max_abs_err gl_ola_nola={e_ola:.3e} "
              f"gl_frame_window={e_frame:.3e} glue={full_err:.3e} (tolerance 1e-4)")
        check(max(e_ola, e_frame, full_err) <= 1e-4, f"glue kernel disagrees at nf={nf}")

        # rfft(glue(irfft S)) == stft(istft S), the consistency it stands for
        S = torch.complex(torch.randn((1025, nf), generator=gen),
                          torch.randn((1025, nf), generator=gen)).cuda()
        want = tstft.stft(tstft.istft(S, hop), n_fft, hop)
        F = torch.fft.irfft(S.transpose(0, 1).contiguous(), n=n_fft, dim=-1)
        got = torch.fft.rfft(glue.gl_consistency_frames(F, window, inv), dim=-1).transpose(0, 1)
        st_err = float((got - want).abs().max())
        print(f"kernel nf={nf}: rfft(glue(irfft S)) vs stft(istft S) max_abs_err={st_err:.3e} "
              "(tolerance 1e-3 abs + 1e-3 rel)")
        check(bool(torch.allclose(got, want, atol=1e-3, rtol=1e-3)),
              f"glue breaks stft/istft consistency at nf={nf}")

        if nf == 5160:  # the 30 s serving shape: time kernels and plain versions
            f4 = 4
            ola_bytes = f4 * (nf * n_fft + n_fft + 2 * (nf + 7) * hop)
            frame_bytes = f4 * ((nf + 7) * hop + n_fft + nf * n_fft)
            glue_bytes = f4 * (2 * nf * n_fft + n_fft + (nf + 7) * hop)
            timing["gl_ola_nola"] = dict(
                ms=cuda_ms(lambda: glue.ola_nola(frames, window, inv)),
                plain_ms=cuda_ms(lambda: glue.ola_nola_reference(frames, window, inv)),
                bound=bound_ms(ola_bytes, (nf + 7) * hop * (2 * 8 + 1)))
            timing["gl_frame_window"] = dict(
                ms=cuda_ms(lambda: glue.frame_window(y_plain, window, nf)),
                plain_ms=cuda_ms(lambda: glue.frame_window_reference(y_plain, window, nf)),
                bound=bound_ms(frame_bytes, nf * n_fft))
            whole = dict(
                ms=cuda_ms(lambda: glue.gl_consistency_frames(frames, window, inv)),
                plain_ms=cuda_ms(lambda: glue.gl_consistency_frames_reference(frames, window, inv)),
                bound=bound_ms(glue_bytes, (nf + 7) * hop * 17 + nf * n_fft))
            for name, t in list(timing.items()) + [("glue (both kernels)", whole)]:
                print(f"timing nf=5160 {name}: kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                      f"bound_us={t['bound'][0] * 1e3:.2f} ({t['bound'][1]})")
            print("library_ms: no single PyTorch call computes the glue (window, "
                  "overlap-add, NOLA, crop, reflect pad, frame, window); none timed")
    return errs, timing


# ---- phase 4: main path ----------------------------------------------------

def make_song(rng, duration: float, Note):
    """Seeded random diatonic notes; the last one ends at duration - 0.1 s,
    which fixes the MIDI's frame count."""
    scale = (0, 2, 4, 5, 7, 9, 11)
    end = duration - 0.1
    notes, t = [], 0.0
    while t < end - 0.2:
        pitch = int(48 + 12 * rng.integers(0, 3) + scale[int(rng.integers(0, 7))])
        stop = min(t + float(rng.uniform(0.15, 0.8)), end)
        notes.append(Note(pitch, int(rng.integers(50, 120)), round(t, 4), round(stop, 4)))
        t += float(rng.uniform(0.1, 0.5))
    last = notes[-1]
    notes[-1] = Note(last.pitch, last.velocity, last.start, end)
    return notes


def render(notes, duration: float, sr: int = 44100) -> np.ndarray:
    """Harmonic additive rendering (4 partials, exponential decay), 0.5 peak."""
    y = np.zeros(int(duration * sr))
    for n in notes:
        s, e = int(n.start * sr), min(int(n.end * sr), len(y))
        if e <= s:
            continue
        t = np.arange(e - s) / sr
        f0 = 440.0 * 2.0 ** ((n.pitch - 69) / 12.0)
        seg = sum(a * np.sin(2 * np.pi * f0 * k * t) for k, a in ((1, 1.0), (2, 0.5), (3, 0.3), (4, 0.2)))
        y[s:e] += (n.velocity / 127.0) * np.exp(-1.5 * t) * seg
    return (0.5 * y / np.abs(y).max()).astype(np.float32)


def main_path(torch, glue, tmp):
    from ml_music_style_transfer_tpu_torch.config import ModelConfig
    from ml_music_style_transfer_tpu_torch.data.audio_io import read_wav, write_wav
    from ml_music_style_transfer_tpu_torch.infer import AudioSynthesizer
    from ml_music_style_transfer_tpu_torch.midi import Note
    from ml_music_style_transfer_tpu_torch.midi import writer as midi_writer
    from ml_music_style_transfer_tpu_torch.models import PerformanceNet

    t0 = time.perf_counter()
    cfg = ModelConfig()  # full width, bfloat16 compute
    model = PerformanceNet(cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    state = model.state_dict()
    del model
    torch.cuda.synchronize()
    print(f"model: PerformanceNet width_mult={cfg.width_mult} compute={cfg.compute_dtype} params={n_params} "
          f"built in {time.perf_counter() - t0:.2f} s")
    check(n_params == FULL_WIDTH_PARAMS, f"param count {n_params} != {FULL_WIDTH_PARAMS}")

    class TimedSynth(AudioSynthesizer):
        """Synchronises around the two device phases to time them apart."""

        def _predict_device(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            spec, t_total = super()._predict_device(*a, **kw)
            torch.cuda.synchronize()
            self.fwd_s, self.spec, self.t_total = time.perf_counter() - t, spec, t_total
            return spec, t_total

        def _griffinlim_device(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            wav = super()._griffinlim_device(*a, **kw)
            torch.cuda.synchronize()
            self.gl_s = time.perf_counter() - t
            return wav

        def synthesize_waveform(self, *a, **kw):
            self.wav = super().synthesize_waveform(*a, **kw)
            return self.wav

    rng = np.random.default_rng(0)
    inputs, last = [], None
    for i, (midi_s, wav_s) in enumerate(REQUESTS):
        notes = make_song(rng, midi_s, Note)
        midi = os.path.join(tmp, f"req{i}.mid")
        wav = os.path.join(tmp, f"req{i}.wav")
        midi_writer.save(midi, notes)
        write_wav(wav, render(notes, wav_s))
        inputs.append((midi, wav))

    glue.reset_launches()  # counts from here on are the main path's
    first = None
    for i, ((midi, wav), (midi_s, wav_s)) in enumerate(zip(inputs, REQUESTS)):
        before = dict(glue.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        synth = TimedSynth(tmp, midi, wav, model_cfg=cfg, params=state, device="cuda")
        (out_path,) = synth.inference(n_iter=N_ITER, output_dir=tmp)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        y = synth.wav
        n_tiles = len(synth._chunk_starts)
        print(f"request {i + 1}: midi={midi_s:.0f}s timbre={wav_s}s t_total={synth.t_total} "
              f"tiles={n_tiles} gl_frames={-(-synth.t_total // GL_BUCKET) * GL_BUCKET} "
              f"forward+blend_s={synth.fwd_s:.4f} griffinlim_s={synth.gl_s:.4f} total_s={total:.4f} "
              f"max_memory_allocated_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}"
              + (" (warm)" if i == 2 else ""))
        check(y.shape == (synth.t_total * 256,), f"request {i + 1}: waveform length {y.shape}")
        check(bool(np.isfinite(y).all()) and float(np.abs(y).max()) > 0.0,
              f"request {i + 1}: waveform not finite or all zero")
        disk, sr = read_wav(out_path, sr=None)
        check(sr == 44100 and len(disk) == len(y), f"request {i + 1}: written WAV mismatch")
        for k in glue.LAUNCHES:
            d = glue.LAUNCHES[k] - before[k]
            check(d == N_ITER, f"request {i + 1}: {k} launched {d} times, expected {N_ITER}")
        if first is None:
            first = synth
        last = synth
    launches = dict(glue.LAUNCHES)
    print(f"launches on the main path: {launches}")
    for k, v in launches.items():
        check(v == N_ITER * len(REQUESTS), f"{k}: {v} launches on the main path")

    # Griffin-Lim through the kernels vs the plain path, same phase, on the
    # first request's predicted spectrogram (not counted above)
    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl

    spec = first.spec[: -(-first.t_total // GL_BUCKET) * GL_BUCKET].transpose(0, 1)
    mag = torch.sqrt(torch.expm1(torch.clamp(spec, 0.0, 20.0)))
    phase = 2 * np.pi * torch.rand(mag.shape, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        a = tgl.griffinlim(mag, n_iter=8, init_phase=phase, device="cuda")
        b = tgl.griffinlim(mag, n_iter=8, init_phase=phase, use_pallas_glue=False, device="cuda")
    gl_err = float((a - b).abs().max() / b.abs().max())
    print(f"griffinlim kernel vs plain path (8 iters, {mag.shape[1]} frames): "
          f"max_abs_err/peak={gl_err:.3e} (tolerance 1e-3)")
    check(gl_err <= 1e-3, "Griffin-Lim through the kernels disagrees with the plain path")
    return launches, last


# ---- phase 5: where the Griffin-Lim time goes ------------------------------

def profile_phase(torch, synth, n_iter: int = 100) -> None:
    """Per-iteration cost of the Griffin-Lim loop (``gl_steps``) on the warm
    request's magnitude, without the per-call phase draw and final istft:
    wall time on the host clock (best of 3), device time by kernel from
    torch.profiler, and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
    from ml_music_style_transfer_tpu_torch.ops import stft as tstft

    spec = synth.spec[: -(-synth.t_total // GL_BUCKET) * GL_BUCKET].transpose(0, 1)
    mag = tstft.inverse_log_power(spec)
    phase = 2 * np.pi * torch.rand(mag.shape, device="cuda",
                                   generator=torch.Generator(device="cuda").manual_seed(2))
    carry = (torch.polar(torch.ones_like(phase), phase), torch.zeros_like(phase, dtype=torch.complex64))

    def loop(n: int) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        tgl.gl_steps(mag, carry, n, 256, 2048)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    with torch.inference_mode():
        loop(2)  # warm-up
        wall_us = min(loop(n_iter) for _ in range(3)) / n_iter * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop(n_iter)
    # device-side events only (kernels, copies), not the aten ops that launched them
    rows = sorted(((dev_us(e) / n_iter, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), reverse=True)
    device_us = sum(us for us, _ in rows)
    print(f"profile: griffinlim loop per iteration at {spec.shape[1]} frames ({n_iter} iters): "
          f"wall {wall_us:.1f} us, device {device_us:.1f} us, device busy {100 * device_us / wall_us:.1f} %")
    for us, key in rows[:12]:
        print(f"profile: {us:8.1f} us/iter {100 * us / device_us:5.1f} % {key[:100]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    # float32 results are compared below: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ml_music_style_transfer_tpu_torch.ops import stft as tstft
    from ml_music_style_transfer_tpu_torch.ops.kernels import _build
    from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue as glue

    smi = smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; "
          "allow_tf32 matmul=False cudnn=False")

    secs = _build.build_all()
    print(f"build: {secs:.2f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    errs, timing = kernel_phase(torch, glue, tstft)
    with tempfile.TemporaryDirectory() as tmp:
        launches, warm = main_path(torch, glue, tmp)
        profile_phase(torch, warm)

    kernels = []
    for name, src_line in (("gl_ola_nola", "ml_music_style_transfer_tpu/ops/pallas/gl_glue.py:95"),
                           ("gl_frame_window", "ml_music_style_transfer_tpu/ops/pallas/gl_glue.py:110")):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ml_music_style_transfer_tpu_torch/csrc/gl_glue.cu",
            "replaces": src_line, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
