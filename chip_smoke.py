#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and data paths and its
fused conv-block kernel on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Imports only the port (``ml_music_style_transfer_tpu_torch``), torch, numpy,
scipy and the standard library. Phases, each reported on its own lines:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for every float32 comparison below;
  2. build: compile the CUDA kernels from ``ml_music_style_transfer_tpu_torch/csrc``;
  3. glue kernels vs plain: the Griffin-Lim glue kernels against their
     plain PyTorch versions on the card at nf = 100 and at the 30 s serving
     shape nf = 5160 (max abs error <= 1e-4), rfft(glue(irfft S)) against
     stft(istft S) (<= 1e-3), and each kernel's time beside its plain
     version's and its memory bound;
  4. serving path: a full-width PerformanceNet (731,945,857 params,
     bfloat16 compute, seeded random weights) serves three requests (10 s,
     30 s and 30 s of MIDI, timbre clips of 6 s, 30 s and 27.5 s) through
     ``AudioSynthesizer.inference`` with 300 Griffin-Lim iterations; each
     waveform is checked, each request must launch each glue kernel 300
     times and the dropout kernel never. Then Griffin-Lim through the
     kernels is held against the plain path on the first request's
     spectrogram;
  5. profile: the Griffin-Lim loop's wall time per iteration, device time
     by kernel (torch.profiler) and device busy share on the warm
     request's spectrogram;
  6. whole clip: ``synthesize_whole_clip`` (one forward over the whole
     clip) of a 30 s and a 180 s MIDI with a 30 s timbre clip, cold and
     warm: waveform of t_out * 256 samples, finite, 300 launches of each
     glue kernel per run; warm seconds and peak memory; then, at each
     clip's Griffin-Lim frame count (5160 and 31,390), the glue kernels
     against their plain versions as in phase 3, and Griffin-Lim through
     the kernels against the plain path (8 iterations, within 1e-3 of the
     peak) on the clip's predicted spectrogram;
  7. batch: ``batch_synthesize_waveforms`` of two 10 s requests and a
     malformed MIDI, which must fail alone; each good waveform within 1e-4
     of its request through ``synthesize_waveform``; 600 launches; then
     Griffin-Lim of a 10 s clip and ``bulk_griffinlim`` of two, timed;
  8. daemon: ``serve_loop`` in this process over 6 requests of 10 s, a
     ``batch`` of two and a ``whole_clip`` request (depth 2; all ok, in
     order, 2700 launches), then the 6 requests serial and pipelined
     (requests/s and their ratio, recorded, not gated); then the async
     seams: a 21 MB upload through ``_stage`` behind about 1 s of queued
     work must return while that work runs (a pageable copy beside it), a
     30 s request's ``fetch()`` must not wait for about 1 s of work queued
     after it, and the host's lead over the card in launches;
  9. dft: Griffin-Lim 300 with ``transform="dft"`` (300 launches) and
     "fft" from one phase at 5160 frames, spectral convergence of each
     (dft may exceed fft by at most 0.01), the loop's time per iteration
     for each; ``log_power_stft`` dft vs fft at the conditioning shape
     (max abs error <= 1e-3 in log space) and their times;
  10. dropout kernel vs plain: at the ten shapes the five DenseConcats give
     it at batch 16 in bfloat16, and one in float32, ``dropout_mask`` and
     ``dropout_apply`` must be bit-equal to their plain versions; keep
     fraction, seed/call-index determinism, the extreme rates' clamped
     thresholds and the backward of ``DropoutFunction``; the kernel's time
     at (16, 384, 860) beside its plain version's, ``F.dropout``'s and its
     bound;
  11. training path: ``Trainer`` at full width and batch 16 on seeded
     synthetic chunks (``ChunkDataset.from_arrays``): ``train_epoch`` (2
     steps), 10 steps on one repeated batch (finite, falling loss) and
     ``evaluate`` over a padded last batch; exactly 10 forward and 10
     backward dropout launches per step and none in eval; the warm step's
     time, frames/s, peak memory and a profile of the top device
     operations. Neither serving nor training may launch the fused conv
     kernel (the model keeps cuDNN's conv, as the JAX model keeps XLA's);
  13. data path at full width (right after phase 11, on its trainer):
     ``make_dataset_dir`` of 6 songs x 30 s x 2 styles (gentleman,
     harpsichord, rms); the port's preprocessing (``get_arrays`` with
     ``store_audio``: the card's machine has no h5py, so the arrays stay in
     memory, as ``load_dataset`` would read them) of 4 train and 2 test
     songs with the device STFT backend (seconds per (song, style),
     frames/s), one song again with the host (NumPy) backend, which must
     agree within 5e-4 in log space; the schema's keys, shapes and dtype;
     the native assembler's batch bit-equal to the Python assembly for the
     same draws; ``gather_batch`` on a float32 ``DeviceDataStore`` within
     5e-4 of the host batch of stored spectrograms, and the bf16 store's
     target difference; then ``train_epoch_resident`` (10 + 10 dropout
     launches per step) and ``evaluate_resident`` (none) at full width,
     bf16; then resident epochs against host-fed epochs (native assembler,
     page-locked slots), 8 timed epochs each: seconds per step, frames/s,
     device busy share and peak memory of each;
  14. store at MusicNet-piano scale: a bf16 ``DeviceDataStore`` of 1,700
     chunks x 5 styles made on the card from a seed (``hbm_bytes``: 3.74 GB
     of audio, 0.37 GB of int8 rolls), the warm resident step at batch 16
     beside the full-width model and Adam (12 steps: median seconds,
     frames/s, busy share from 3 profiled steps, peak memory); then the
     ``metric`` lines of ``scripts/bench_train.py`` under its names, for
     the host-fed (phase 13) and the resident (phase 14) step, and
     ``preprocess_frames_per_sec``;
  12. fused conv kernel: the SASS of ``libfused_conv.so`` must hold wgmma
     (``HGMMA``) and TMA loads (``UTMALDG``) and no ``mma.sync`` (``HMMA``)
     or ``cp.async`` (``LDGSTS``); one full-width forward's 64 conv1x3 ->
     InstanceNorm -> LeakyReLU blocks (``model_layer_shapes`` at batch 16,
     bfloat16) through ``conv1x3_instnorm_lrelu``, which must count 64
     launches; at each of the 31 distinct shapes the kernel against its
     plain version (per element |kernel - plain| <= 2^-7 |plain| + 1e-3 in
     bfloat16, and 2e-4 in float32 at three shapes), then its time beside
     the plain version's, the cuDNN composite's (``bench_fused_conv.measure``)
     and its bound, the CTAs its GEMM launches and the composite's time over
     the kernel's; the launch-weighted totals and ratio over the 64 blocks.

Lines starting ``metric`` carry the serving system's numbers under the
names ``scripts/bench_inference.py`` prints, and the train step's under
``scripts/bench_train.py``'s. The glue kernels' ``launches`` in the
kernels' JSON record sum their counts over phases 4 and 6-9, the dropout
kernel's over phases 11 (12 steps), 13 (the resident epoch and the
evaluation) and 14 (12 steps). The
line before the last is the card's name and power limit, the one before it
the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero, and
without a card the script exits non-zero before printing any result.
"""
from __future__ import annotations

import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM tensor cores, dense bfloat16
# int32 ALU: 64 lanes per SM against float32's 128, one op per lane-cycle
# against an FMA's two, so a quarter of the float32 FLOP rate
INT32_OPS_PER_S = F32_FLOPS_PER_S / 4
FULL_WIDTH_PARAMS = 731_945_857
SPIN_CYCLES = 100_000_000  # about 50 ms at the H100's 1.98 GHz boost clock
N_ITER = 300
REQUESTS = ((10.0, 6.0), (30.0, 30.0), (30.0, 27.5))  # (MIDI s, timbre WAV s)
GL_BUCKET = 430  # Griffin-Lim runs over the MIDI's frames rounded up to half a chunk
WHOLE_CLIP_SECONDS = (30.0, 180.0)
ASYNC_SECONDS = 30.0  # MIDI length of the async probe's request


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(fn, n: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls (CUDA events).

    The card first spins for about 50 ms (``torch.cuda._sleep``) while the
    host queues all ``n`` calls behind it, so the events time the kernels
    back to back and not the host's rate of launching them (a Python
    wrapper takes tens of microseconds per call, longer than a small
    kernel runs)."""
    import torch

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


def dev_us(e) -> float:
    """A torch.profiler event's own device time in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def bound_ms(n_bytes: float, n_flops: float, n_int_ops: float = 0.0,
             n_bf16_flops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the operations'
    time: float32 FLOPs, int32 ops and bfloat16 tensor-core FLOPs, each at
    its own peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = (n_flops / F32_FLOPS_PER_S + n_int_ops / INT32_OPS_PER_S
             + n_bf16_flops / BF16_FLOPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---- phase 3: kernels vs plain ---------------------------------------------

def glue_vs_plain(torch, glue, tstft, nf: int, errs: dict):
    """The glue kernels against their plain versions on seeded frames at
    ``nf`` frames (max abs error <= 1e-4, folded into ``errs``), and
    rfft(glue(irfft S)) against stft(istft S) (<= 1e-3). Returns the
    inputs for timing."""
    n_fft, hop = 2048, 256
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
    return frames, window, inv, y_plain


def kernel_phase(torch, glue, tstft):
    n_fft, hop = 2048, 256
    errs = {"gl_ola_nola": 0.0, "gl_frame_window": 0.0}
    timing = {}
    for nf in (100, 5160):
        frames, window, inv, y_plain = glue_vs_plain(torch, glue, tstft, nf, errs)
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


def main_path(torch, glue, dk, binf, tmp):
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

    glue.reset_launches()  # counts from here on are the serving path's
    dk.reset_launches()
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
    print(f"launches on the serving path: {launches} dropout {dict(dk.LAUNCHES)}")
    print(binf.metric_line("serving_s_per_30s_clip", total, "s", torch.device("cuda"),
                           midi_s=REQUESTS[-1][0], n_iter=N_ITER, request="3 (warm)"))
    for k, v in launches.items():
        check(v == N_ITER * len(REQUESTS), f"{k}: {v} launches on the serving path")
    check(not any(dk.LAUNCHES.values()), "serving launched the dropout kernel")

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
    return launches, last, state


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


# ---- phases 6-9: the serving system ----------------------------------------

def counted(glue, per_kernel: int, what: str) -> int:
    """Read the glue kernels' counts right after a path's run (they were set
    to 0 just before it); each must equal ``per_kernel``."""
    got = dict(glue.LAUNCHES)
    for k, v in got.items():
        check(v == per_kernel, f"{what}: {k} launched {v} times, expected {per_kernel}")
    return per_kernel


def midi_frames(path: str) -> int:
    from ml_music_style_transfer_tpu_torch.midi import parser as midi_parser
    from ml_music_style_transfer_tpu_torch.midi import pianoroll as pr

    return pr.vectorize_notes(midi_parser.load(path).notes, 172)[0].shape[0]


def whole_clip_phase(torch, glue, tstft, binf, make_synth, tmp, errs: dict) -> int:
    """``synthesize_whole_clip`` on a 30 s and a 180 s MIDI (30 s timbre
    clip): one forward over the whole clip, Griffin-Lim over its frames;
    cold then warm, 300 launches of each glue kernel per run. Then, at each
    clip's Griffin-Lim frame count, the glue kernels against their plain
    versions and Griffin-Lim (8 iterations) through the kernels against the
    plain path on the clip's predicted spectrogram."""
    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
    from ml_music_style_transfer_tpu_torch.parallel import time_shard as tsh

    n = 0
    for midi_s in WHOLE_CLIP_SECONDS:
        midi, wav = binf.make_clip(tmp, f"whole{int(midi_s)}", midi_s, 20 + int(midi_s),
                                   timbre_seconds=30.0)
        t_total = midi_frames(midi)
        t_out = tsh.time_sharded_output_length(t_total)
        synth = make_synth(midi, wav)
        times = []
        for run in ("cold", "warm"):
            glue.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = synth.synthesize_whole_clip(n_iter=N_ITER)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            n += counted(glue, N_ITER, f"whole clip {midi_s:.0f} s ({run})")
            check(y.shape == (t_out * 256,), f"whole clip {midi_s:.0f} s: length {y.shape}")
            check(bool(np.isfinite(y).all()) and float(np.abs(y).max()) > 0.0,
                  f"whole clip {midi_s:.0f} s: waveform not finite or all zero")
        gl_frames = -(-t_out // GL_BUCKET) * GL_BUCKET
        print(f"whole clip midi={midi_s:.0f}s t_total={t_total} t_out={t_out} "
              f"gl_frames={gl_frames} cold_s={times[0]:.4f} "
              f"warm_s={times[1]:.4f} max_memory_allocated_GB="
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        if midi_s == 30.0:
            print(binf.metric_line("whole_clip_s_per_30s_clip", times[1], "s",
                                   torch.device("cuda"), midi_s=midi_s, n_iter=N_ITER))

        # the kernels at this path's shape (not counted above)
        glue_vs_plain(torch, glue, tstft, gl_frames, errs)
        spec, _ = synth._predict_whole_clip_device()
        mag = torch.sqrt(torch.expm1(torch.clamp(spec.transpose(0, 1), 0.0, 20.0)))
        phase = 2 * np.pi * torch.rand(mag.shape, generator=torch.Generator().manual_seed(4))
        with torch.inference_mode():
            a = tgl.griffinlim(mag, n_iter=8, init_phase=phase, device="cuda")
            b = tgl.griffinlim(mag, n_iter=8, init_phase=phase, use_pallas_glue=False,
                               device="cuda")
        gl_err = float((a - b).abs().max() / b.abs().max())
        print(f"whole clip midi={midi_s:.0f}s: griffinlim kernel vs plain path (8 iters, "
              f"{mag.shape[1]} frames): max_abs_err/peak={gl_err:.3e} (tolerance 1e-3)")
        check(mag.shape[1] == gl_frames and gl_err <= 1e-3,
              f"whole clip {midi_s:.0f} s: Griffin-Lim through the kernels disagrees")
        del spec, mag, phase, a, b
    return n


def batch_phase(torch, glue, binf, make_synth, tmp) -> int:
    """Three requests through ``batch_synthesize_waveforms``: two 10 s
    songs and a malformed MIDI, which must come back
    as an error alone; each good waveform within 1e-4 of the same request
    through ``synthesize_waveform``. Then Griffin-Lim of a 10 s clip alone
    and ``bulk_griffinlim`` of the two, timed."""
    from ml_music_style_transfer_tpu_torch.infer import bulk
    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl

    clips = [binf.make_clip(tmp, f"batch{i}", 10.0, 30 + i) for i in range(2)]
    bad = os.path.join(tmp, "malformed.mid")
    with open(bad, "wb") as f:
        f.write(b"MThd this is not a MIDI file")
    synths = [make_synth(*clips[0]), make_synth(bad, clips[0][1]), make_synth(*clips[1])]
    glue.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    wavs, errors = bulk.batch_synthesize_waveforms(synths, n_iter=N_ITER)
    dt = time.perf_counter() - t
    n = counted(glue, 2 * N_ITER, "batch of 3 (one malformed)")
    print(f"batch: 3 requests in {dt:.4f} s, errors {errors}")
    check(errors[0] is None and errors[2] is None, f"batch: a good request failed: {errors}")
    check(errors[1] is not None and wavs[1] is None, "batch: the malformed request was not isolated")
    for i in (0, 2):
        want = synths[i].synthesize_waveform(n_iter=N_ITER)
        err = float(np.abs(wavs[i] - want).max())
        print(f"batch request {i + 1}: {len(wavs[i])} samples, max_abs_err vs single request "
              f"{err:.3e} (tolerance 1e-4)")
        check(wavs[i].shape == want.shape and err <= 1e-4,
              f"batch request {i + 1} differs from its single request")

    specs = []
    for s in (synths[0], synths[2]):
        spec, t_total = s._predict_device(s.midi_source, s.audio_source)
        specs.append(spec[: s.gl_frames(spec, t_total)].transpose(0, 1))
    specs = torch.stack(specs)
    dev = torch.device("cuda")

    def one():
        with torch.inference_mode():
            tgl.griffinlim_from_log_power(specs[0], n_iter=N_ITER, device=dev).cpu()

    def both():
        bulk.bulk_griffinlim(specs, [0, 1], n_iter=N_ITER, device=dev).cpu()

    print(binf.metric_line("griffinlim_s_per_10s_clip", binf.best_seconds(one, dev), "s", dev,
                           frames=specs.shape[-1], n_iter=N_ITER))
    print(binf.metric_line("batch_griffinlim_s_per_clip", binf.best_seconds(both, dev) / 2, "s",
                           dev, clips=2, frames=specs.shape[-1], n_iter=N_ITER))
    return n


def daemon_phase(torch, glue, binf, make_synth, tmp) -> int:
    """``serve_loop`` in this process: 6 requests of 10 s, a ``batch`` of
    two and a ``whole_clip`` request at depth 2, all answered in order with
    ok; then the 6 single requests serial (depth 0) and pipelined (depth 2),
    timed; then the async seams: a 21 MB upload through ``_stage`` behind
    about 1 s of queued work must return while that work runs (a pageable
    copy is timed beside it); a 30 s request's ``fetch()`` must return while
    about 1 s of work queued after the request still runs (its call's
    return time and whether its work was pending then are printed); and
    the number of launches the host can queue ahead of the card."""
    clips = [binf.make_clip(tmp, f"daemon{i}", 10.0, 40 + i) for i in range(6)]
    singles = [{"midi": m, "audio": w, "out": os.path.join(tmp, f"daemon{i}.wav"),
                "n_iter": N_ITER} for i, (m, w) in enumerate(clips)]
    mixed = singles + [
        {"batch": [{"midi": m, "audio": w, "out": os.path.join(tmp, f"daemon_b{i}.wav")}
                   for i, (m, w) in enumerate(clips[:2])], "n_iter": N_ITER},
        {"midi": clips[2][0], "audio": clips[2][1], "out": os.path.join(tmp, "daemon_w.wav"),
         "n_iter": N_ITER, "whole_clip": True}]
    glue.reset_launches()
    _, resps = binf.daemon_seconds(make_synth, mixed, 2)
    n = counted(glue, 9 * N_ITER, "daemon, 6 requests + batch of 2 + whole clip")
    outs = [r.get("out") for r in resps[:6]] + [None, resps[7].get("out")]
    check(len(resps) == 8 and all(r["ok"] for r in resps)
          and all(r["ok"] for r in resps[6]["batch"]), f"daemon: a request failed: {resps}")
    check(outs[:6] == [r["out"] for r in singles] and outs[7] == mixed[7]["out"],
          "daemon: responses out of order")
    rps = {}
    for depth in (0, 2):
        glue.reset_launches()
        dt, resps = binf.daemon_seconds(make_synth, singles, depth)
        n += counted(glue, 6 * N_ITER, f"daemon, 6 requests at depth {depth}")
        check(all(r["ok"] for r in resps), f"daemon depth {depth}: {resps}")
        rps[depth] = 6 / dt
    dev = torch.device("cuda")
    print(binf.metric_line("daemon_requests_per_s_serial", rps[0], "requests/s", dev, requests=6,
                           midi_s=10.0))
    print(binf.metric_line("daemon_requests_per_s_pipelined", rps[2], "requests/s", dev,
                           requests=6, midi_s=10.0,
                           pipelined_over_serial=round(rps[2] / rps[0], 4)))

    # the serving seam's uploads do not wait for earlier work on the card
    # (a plain pageable copy does), and a request's fetch() waits for that
    # request only; how far ahead the host can run is bounded by the card's
    # queue of pending launches, measured last
    stage = binf.staging_probe(dev)
    print("async: 21 MB upload behind ~1 s of queued work: " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in stage.items()))
    check(stage["staged_returned_while_earlier_work_ran"],
          "the serving upload seam waited for earlier work on the card")
    synth = make_synth(*binf.make_clip(tmp, "async", ASYNC_SECONDS, 50))
    glue.reset_launches()
    probe = binf.async_probe(synth, N_ITER)
    n += counted(glue, N_ITER, "async probe")
    print(f"async: synthesize_waveform_async of a {ASYNC_SECONDS:.0f} s request returned after "
          f"{probe['return_s']:.4f} s, its work pending then: {probe['pending_at_return']}; "
          f"fetch() with ~1 s of later work queued returned after {probe['fetch_s']:.4f} s, "
          f"the later work still running: {probe['later_work_running_at_fetch']}")
    check(probe["later_work_running_at_fetch"], "fetch() waited for work queued after its request")
    ahead = binf.launch_queue_probe(dev)
    print(f"async: behind ~1 s of queued work the host queued {ahead} tiny kernels before a "
          "launch blocked (the card's queue of pending launches)")
    return n


def spectral_convergence(torch, tstft, wav, mag) -> float:
    """|| |STFT(wav)| - mag ||_F / || mag ||_F over mag's frames."""
    got = tstft.stft(wav, 2048, 256).abs()[:, : mag.shape[1]]
    return float(torch.linalg.norm(got - mag) / torch.linalg.norm(mag))


def dft_phase(torch, glue, tstft, binf, synth, tmp) -> int:
    """``transform="dft"`` against "fft" at 5160 frames (the warm 30 s
    request's spectrogram): one Griffin-Lim of 300 iterations each from the
    same phase (300 launches of each glue kernel for the dft run), their
    spectral convergence, and the loop's time per iteration (fft, dft, dft,
    fft); then ``log_power_stft`` dft against fft at the conditioning shape."""
    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl

    spec = synth.spec[: synth.gl_frames(synth.spec, synth.t_total)].transpose(0, 1)
    mag = tstft.inverse_log_power(spec)
    phase = 2 * np.pi * torch.rand(mag.shape, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        glue.reset_launches()
        w_dft = tgl.griffinlim(mag, n_iter=N_ITER, init_phase=phase, transform="dft", device="cuda")
        torch.cuda.synchronize()
        n = counted(glue, N_ITER, "griffinlim transform=dft")
        w_fft = tgl.griffinlim(mag, n_iter=N_ITER, init_phase=phase, transform="fft", device="cuda")
        sc = {"fft": spectral_convergence(torch, tstft, w_fft, mag),
              "dft": spectral_convergence(torch, tstft, w_dft, mag)}
    diff = sc["dft"] - sc["fft"]
    print(f"dft: griffinlim 300 iters at {mag.shape[1]} frames, spectral convergence "
          f"fft={sc['fft']:.5f} dft={sc['dft']:.5f} dft-fft={diff:+.5f} (tolerance +0.01)")
    check(np.isfinite(w_dft.cpu().numpy()).all() and diff <= 0.01,
          "transform=dft: Griffin-Lim worse than the FFT path beyond the tolerance")

    carry = (torch.polar(torch.ones_like(phase), phase).cuda(),
             torch.zeros(mag.shape, dtype=torch.complex64, device="cuda"))

    def loop(transform: str, iters: int = 100) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        tgl.gl_steps(mag, carry, iters, 256, 2048, transform=transform)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / iters * 1e6

    with torch.inference_mode():
        loop("fft", 2)
        loop("dft", 2)
        us = {"fft": [], "dft": []}
        for tr in ("fft", "dft", "dft", "fft"):
            us[tr].append(min(loop(tr) for _ in range(2)))
    print(f"dft: griffinlim loop per iteration at {mag.shape[1]} frames (100 iters, best of 2, "
          f"fft dft dft fft): fft_us={us['fft']} dft_us={us['dft']} "
          f"dft/fft={min(us['dft']) / min(us['fft']):.3f}")

    _, wav = binf.make_clip(tmp, "cond30", 30.0, 60)
    from ml_music_style_transfer_tpu_torch.data.audio_io import read_wav

    audio, _ = read_wav(wav)
    half, bucket = 1024, GL_BUCKET
    a = np.pad(audio, (half, half), mode="reflect")
    n_valid = 1 + len(audio) // 256
    target = (-(-n_valid // bucket) * bucket - 1) * 256 + 2048
    a = torch.from_numpy(np.pad(a, (0, max(0, target - len(a))))[:target]).cuda()
    lp = {tr: tstft.log_power_stft(a, 2048, 256, transform=tr, center=False)
          for tr in ("fft", "dft")}
    err = float((lp["dft"] - lp["fft"]).abs().max())
    ms = {tr: cuda_ms(lambda tr=tr: tstft.log_power_stft(a, 2048, 256, transform=tr, center=False),
                      n=20) for tr in ("fft", "dft")}
    print(f"dft: log_power_stft at the conditioning shape {tuple(lp['fft'].shape)}: dft vs fft "
          f"max_abs_err={err:.3e} in log space (tolerance 1e-3); fft_ms={ms['fft']:.4f} "
          f"dft_ms={ms['dft']:.4f} (float32 matmul, no TF32)")
    check(err <= 1e-3, "log_power_stft dft differs from fft beyond 1e-3")
    return n


# ---- phase 10: dropout kernel vs plain -------------------------------------

DROPOUT_RATE = 0.2
DROPOUT_SEED = 0x9E3779B97F4A7C15
# Least int32 work per element: a Philox4x32-10 call per 4 elements is 10
# rounds of two 32x32->64 multiplies (one IMAD.WIDE each) and two
# three-input XORs (one LOP3 each); the key bumps are per-launch constants;
# then a compare and a select per element
PHILOX_INT_OPS_PER_ELEMENT = 10 * (2 + 2) / 4 + 2
TIMED_SHAPE = (16, 384, 860)  # the largest dropout call of a batch-16 step


def dense_concat_shapes(batch: int = 16) -> list[tuple[int, int, int]]:
    """The (B, C, T) tensors the five DenseConcats hand to dropout at full
    width: hidden (1.5 C) and output (C) at C = 4096..256, T = 53..860."""
    from ml_music_style_transfer_tpu_torch.config import ModelConfig
    from ml_music_style_transfer_tpu_torch.models import temporal_ladder

    cfg = ModelConfig()
    t_enc = temporal_ladder()["encoder"]
    shapes = []
    for i in range(cfg.depth):
        c, t = cfg.midi_channel_plan[-(i + 1)], t_enc[-(i + 1)]
        shapes += [(batch, int(c * 1.5), t), (batch, c, t)]
    return shapes


def dropout_phase(torch, dk):
    import torch.nn.functional as F

    seed, rate = DROPOUT_SEED, DROPOUT_RATE
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [(s, torch.bfloat16) for s in dense_concat_shapes()] + [(TIMED_SHAPE, torch.float32)]
    err = 0.0
    for ci, (shape, dtype) in enumerate(cases):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        m = dk.dropout_mask(seed, ci, shape, rate, dtype)
        y = dk.dropout_apply(x, seed, ci, rate)
        m_ref = dk.dropout_mask_reference(seed, ci, shape, rate, dtype, "cuda")
        y_ref = dk.dropout_apply_reference(x, seed, ci, rate)
        torch.cuda.synchronize()
        e = max(float((m.float() - m_ref.float()).abs().max()),
                float((y.float() - y_ref.float()).abs().max()))
        err = max(err, e)
        same = torch.equal(m, m_ref) and torch.equal(y, y_ref)
        print(f"dropout {tuple(shape)} {str(dtype)[6:]} call {ci}: bit-equal={same} "
              f"max_abs_err={e:.3e} kept={float((m != 0).float().mean()):.5f}")
        check(same, f"dropout kernel differs from its plain version at {shape} {dtype}")

    m = dk.dropout_mask(seed, 0, TIMED_SHAPE, rate, torch.bfloat16)
    kept = float((m != 0).float().mean())
    print(f"dropout keep fraction at {m.numel()} elements: {kept:.6f} (want 0.8 +- 1e-3)")
    check(abs(kept - (1.0 - rate)) < 1e-3, "dropout keep fraction out of range")
    check(torch.equal(m, dk.dropout_mask(seed, 0, TIMED_SHAPE, rate, torch.bfloat16)),
          "the same seed gave another mask")
    check(not torch.equal(m, dk.dropout_mask(seed + 1, 0, TIMED_SHAPE, rate, torch.bfloat16)),
          "another seed gave the same mask")
    check(not torch.equal(m, dk.dropout_mask(seed, 1, TIMED_SHAPE, rate, torch.bfloat16)),
          "another call_index gave the same mask")
    for r, want in ((1.0 - 2.0**-40, 0), (1.0 - 2.0**-33, 0), (0.5, round(0.5 * 2**32) - 1),
                    (0.2, round(0.8 * 2**32) - 1), (2.0**-40, 2**32 - 2)):
        check(dk.keep_threshold(r) == want, f"keep_threshold({r}) != {want}")
        mk = dk.dropout_mask(seed, 0, (1 << 16,), r, torch.float32)
        check(torch.equal(mk, dk.dropout_mask_reference(seed, 0, (1 << 16,), r, torch.float32,
                                                        "cuda")), f"rate {r}: kernel != plain")
    n_none = int((dk.dropout_mask(seed, 0, (1 << 16,), 1.0 - 2.0**-40, torch.float32) != 0).sum())
    n_all = int((dk.dropout_mask(seed, 0, (1 << 16,), 2.0**-40, torch.float32) != 0).sum())
    print(f"dropout extreme rates on 65536 elements: rate 1-2^-40 kept {n_none}, "
          f"rate 2^-40 kept {n_all}")
    check(n_none <= 1 and n_all >= (1 << 16) - 1, "extreme rates not clamped")

    x = torch.randn(TIMED_SHAPE, device="cuda", generator=gen).to(torch.bfloat16).requires_grad_()
    g = torch.randn(TIMED_SHAPE, device="cuda", generator=gen).to(torch.bfloat16)
    dk.DropoutFunction.apply(x, seed, 3, rate).backward(g)
    want = g * dk.dropout_mask_reference(seed, 3, TIMED_SHAPE, rate, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    check(torch.equal(x.grad, want), "DropoutFunction's gradient != grad * mask")
    print("dropout backward: grad == grad_out * mask, bit-equal")

    # timing at the largest shape; six inputs in turn (63 MB) so that L2
    # (50 MB) cannot serve a launch from the previous one's data
    n = m.numel()
    xs = [torch.randn(TIMED_SHAPE, device="cuda", generator=gen).to(torch.bfloat16)
          for _ in range(6)]
    turn = itertools.cycle(xs)
    t = dict(
        ms=cuda_ms(lambda: dk.dropout_apply(next(turn), seed, 0, rate)),
        plain_ms=cuda_ms(lambda: dk.dropout_apply_reference(next(turn), seed, 0, rate), n=10),
        library_ms=cuda_ms(lambda: F.dropout(next(turn), rate, training=True)),
        bound=bound_ms(2 * 2 * n, n, n * PHILOX_INT_OPS_PER_ELEMENT))
    mask_ms = cuda_ms(lambda: dk.dropout_mask(seed, 0, TIMED_SHAPE, rate, torch.bfloat16))
    mask_bound = bound_ms(2 * n, 0, n * PHILOX_INT_OPS_PER_ELEMENT)
    print(f"timing {TIMED_SHAPE} bf16 dropout_apply: kernel_ms={t['ms']:.4f} "
          f"plain_ms={t['plain_ms']:.4f} library_ms(F.dropout)={t['library_ms']:.4f} "
          f"bound_us={t['bound'][0] * 1e3:.2f} ({t['bound'][1]}; bytes alone "
          f"{4 * n / HBM_BYTES_PER_S * 1e6:.2f})")
    print(f"timing {TIMED_SHAPE} bf16 dropout_mask: kernel_ms={mask_ms:.4f} "
          f"bound_us={mask_bound[0] * 1e3:.2f} ({mask_bound[1]})")
    return err, t


# ---- phase 11: training path -------------------------------------------------

def train_phase(torch, dk, glue):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
    from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
    from ml_music_style_transfer_tpu_torch.scripts.bench_train import host_arrays
    from ml_music_style_transfer_tpu_torch.train.checkpoint import ExperimentState
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer, device_prefetch

    batch_size = 16
    t0 = time.perf_counter()
    tr = Trainer(ModelConfig(), TrainConfig(batch_size=batch_size, seed=0), device="cuda")
    tr.init_state(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"train: PerformanceNet params={n_params} + Adam built in {time.perf_counter() - t0:.2f} s")
    check(n_params == FULL_WIDTH_PARAMS, f"param count {n_params} != {FULL_WIDTH_PARAMS}")
    train_ds = ChunkDataset.from_arrays(host_arrays(32, seed=1), seed=0)
    test_ds = ChunkDataset.from_arrays(host_arrays(24, seed=2), seed=1)

    def step_launches():
        return dk.LAUNCHES["dropout_apply"], dk.LAUNCHES["dropout_grad"]

    glue.reset_launches()  # counts from here on are the training path's
    dk.reset_launches()
    exp = ExperimentState(1, 1, "chip_smoke")
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.train_epoch(train_ds, epoch=0, log_every=1, exp=exp)
    torch.cuda.synchronize()
    print(f"train: train_epoch of 2 steps (first cold) {time.perf_counter() - t:.3f} s, "
          f"losses {exp.iter_train_loss}")
    check(len(exp.iter_train_loss) == 2 and np.isfinite(exp.iter_train_loss).all(),
          "train_epoch losses not finite")
    check(step_launches() == (20, 20), f"dropout launches after 2 steps: {step_launches()}")

    batch = next(device_prefetch(train_ds.epoch_batches(batch_size), torch.device("cuda")))
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = tr.train_step(batch, tr.next_dropout_seed())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
        check(step_launches() == (20 + 10 * (i + 1),) * 2,
              f"step {i}: dropout launches {step_launches()}, want 10 + 10 per step")
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    print(f"train: 10 steps on one batch, losses {[round(x, 6) for x in losses]}")
    print(f"train: step times s {[round(x, 4) for x in times]}")
    print(f"train: warm step median {step_s:.4f} s, {batch_size * 860 / step_s:.0f} frames/s, "
          f"max_memory_allocated_GB={peak / 1e9:.3f} (batch {batch_size}, bf16 compute)")
    check(bool(np.isfinite(losses).all()), "training loss not finite")
    check(losses[-1] < losses[0], f"loss did not fall over 10 steps: {losses[0]} -> {losses[-1]}")

    before = step_launches()
    test_loss = tr.evaluate(test_ds)
    print(f"train: evaluate over 24 chunks (16 + 8 padded) mse={test_loss:.6f}")
    check(bool(np.isfinite(test_loss)), "eval MSE not finite")
    check(step_launches() == before, "evaluate launched the dropout kernel")
    check(not any(glue.LAUNCHES.values()), "training launched the Griffin-Lim glue")
    launches = sum(step_launches())
    print(f"launches on the training path: {dict(dk.LAUNCHES)} (12 steps)")
    busy = {}

    seed = tr.next_dropout_seed()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            tr.train_step(batch, seed)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies), not the annotations
    # (Optimizer.step#...) that mirror host ranges onto the device's timeline
    rows = sorted(((dev_us(e) / 3e3, e.count // 3, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False) and "#" not in e.key),
                  reverse=True)
    device_ms = sum(ms for ms, _, _ in rows)
    busy.update(step_s=step_s, device_ms=device_ms, peak=peak)
    print(f"profile: train step (3 warm steps under the profiler): device {device_ms:.2f} ms/step "
          f"in {sum(c for _, c, _ in rows)} kernels and copies; device busy "
          f"{100 * device_ms / (step_s * 1e3):.1f} % of the unprofiled warm step")
    for ms, count, key in rows[:15]:
        print(f"profile: {ms:8.3f} ms/step {100 * ms / device_ms:5.1f} % x{count:<4d} {key[:90]}")
    for ms, count, key in rows:
        if "philox_dropout" in key:
            print(f"profile: dropout kernel {ms:.3f} ms/step ({100 * ms / device_ms:.2f} %) "
                  f"in {count} launches: {key[:90]}")
    return launches, tr, busy


# ---- phase 13: the data path at full width -----------------------------------

DATA_STYLES = ("gentleman", "harpsichord")
STFT_TOL = 5e-4  # log space: float32 FFT against float64 (JAX preprocess.py:176, ~2e-4)
SCHEMA = {"pianoroll": (860, 128), "onoff": (860, 128)}
for _s in DATA_STYLES:
    SCHEMA[f"spec_{_s}"] = (1025, 860)
    SCHEMA[f"audio_{_s}"] = (219904,)


def host_batch(ds, idx, cond_idx, style) -> dict:
    """The batch ``ChunkDataset.assemble`` builds for these draws."""
    t = np.stack([ds.specs[ds.styles[s]][i] for i, s in zip(idx, style)])
    c = np.stack([ds.specs[ds.styles[s]][i] for i, s in zip(cond_idx, style)])
    return {"midi": ds.pianoroll[idx], "onoff": ds.onoff[idx], "cond": c, "target": t}


def epoch_rate(torch, bt, run_epoch, n_steps: int, what: str) -> dict:
    """One warm-up epoch, then 8 timed epochs (median seconds per step) and
    one under the profiler (device ms per step, busy share)."""
    run_epoch()
    torch.cuda.reset_peak_memory_stats()
    per_step = bt.epoch_step_seconds(run_epoch, n_steps, torch.device("cuda"), 8)
    step_s = statistics.median(per_step)
    peak = torch.cuda.max_memory_allocated()
    dev_ms = bt.device_ms_per_step(run_epoch, n_steps)
    print(f"data: {what}: epochs of {n_steps} steps, s/step {[round(x, 4) for x in per_step]}, "
          f"median {step_s:.4f} s, {16 * 860 / step_s:.0f} frames/s, device {dev_ms:.2f} ms/step, "
          f"busy {100 * dev_ms / (step_s * 1e3):.1f} %, max_memory_allocated_GB={peak / 1e9:.3f}")
    return dict(step_s=step_s, device_ms=dev_ms, peak=peak)


def data_phase(torch, dk, tr, tmp):
    """Phase 13: synthetic songs -> port preprocessing -> schema -> native
    assembler vs Python -> device store: gather vs host batch -> resident
    training and evaluation at full width (bf16), against host-fed epochs."""
    from ml_music_style_transfer_tpu_torch.data import preprocess as pp
    from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
    from ml_music_style_transfer_tpu_torch.data.device_store import DeviceDataStore, gather_batch
    from ml_music_style_transfer_tpu_torch.scripts import bench_train as bt
    from ml_music_style_transfer_tpu_torch.testing import synthetic

    raw_dir = os.path.join(tmp, "songs")
    t = time.perf_counter()
    synthetic.make_dataset_dir(raw_dir, [1, 2, 3, 4, 5, 6], styles=DATA_STYLES, duration=30.0,
                               seed=0, normalize="rms")
    print(f"data: make_dataset_dir 6 songs x 30 s x {len(DATA_STYLES)} styles (rms) "
          f"{time.perf_counter() - t:.2f} s")
    kw = dict(styles=DATA_STYLES, store_audio=True, device="cuda")
    pp.get_arrays(raw_dir, "train", song_ids=[6], stft_backend="device", **kw)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    train = pp.get_arrays(raw_dir, "train", song_ids=[1, 2, 3, 4], stft_backend="device", **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    n = train["pianoroll"].shape[0]
    print(f"data: preprocess train (4 songs x 2 styles, device STFT, store_audio) {dt:.3f} s, "
          f"{dt / 8:.3f} s per (song, style), {n} chunks, "
          f"{n * len(DATA_STYLES) * 860 / dt:.0f} spectrogram frames/s end to end")
    test = pp.get_arrays(raw_dir, "test", song_ids=[5, 6], stft_backend="device", **kw)
    for name, raw in (("train", train), ("test", test)):
        got = {k: v.shape[1:] for k, v in raw.items()}
        check(got == SCHEMA and len({v.shape[0] for v in raw.values()}) == 1
              and all(v.dtype == np.float32 for v in raw.values()),
              f"{name} arrays break the schema: { {k: v.shape for k, v in raw.items()} }")
    print(f"data: schema ok: { {k: v.shape for k, v in train.items()} } float32; "
          f"test {test['pianoroll'].shape[0]} chunks")
    t = time.perf_counter()
    host = pp.get_arrays(raw_dir, "train", song_ids=[1], stft_backend="host", **kw)
    dt_host = time.perf_counter() - t
    n1 = host["pianoroll"].shape[0]
    err = max(float(np.abs(host[k] - train[k][:n1]).max()) for k in host if k.startswith("spec_"))
    exact = all(np.array_equal(host[k], train[k][:n1]) for k in host if not k.startswith("spec_"))
    print(f"data: song 1 host (NumPy) vs device STFT backend: spec max_abs_err={err:.3e} "
          f"(tolerance {STFT_TOL}), rolls/onoff/audio equal={exact}; host backend {dt_host:.3f} s "
          f"for {n1} chunks x 2 styles")
    check(err <= STFT_TOL and exact, "device and host STFT backends disagree")

    ds = ChunkDataset.from_arrays(train, seed=0)
    rng = np.random.default_rng(5)
    draws = (rng.integers(0, n, 16), rng.integers(0, n, 16), rng.integers(0, 2, 16))
    asm = ds.native_assembler(16, pin_memory=True)
    asm.submit(*draws)
    slot, nb = asm.next()
    pinned = torch.from_numpy(nb["target"]).is_pinned()
    want = host_batch(ds, *draws)
    same = all(np.array_equal(nb[k], want[k]) for k in want)
    asm.release(slot)
    print(f"data: native assembler vs Python assembly, 16 draws: bit-equal={same}; "
          f"slot page-locked={pinned}")
    check(same, "the native assembler's batch differs from the Python assembly")

    store32 = DeviceDataStore.from_arrays(train, seed=0, audio_dtype=torch.float32)
    idx, cond_idx, style = (store32.put_idx(a) for a in draws)
    with torch.no_grad():
        b32 = gather_batch(store32.audio, store32.pianoroll, store32.onoff, idx, cond_idx, style)
        errs = {k: float((b32[k].cpu() - torch.from_numpy(want[k])).abs().max()) for k in want}
    print(f"data: gather_batch (float32 store) on the card vs the host batch of stored "
          f"spectrograms: max_abs_err {errs} (tolerance {STFT_TOL})")
    check(max(errs.values()) <= STFT_TOL, "gather_batch disagrees with the host batch")
    store = DeviceDataStore.from_arrays(train, seed=0)  # bfloat16 audio, the default
    test_store = DeviceDataStore.from_arrays(test, seed=1)
    with torch.no_grad():
        b16 = gather_batch(store.audio, store.pianoroll, store.onoff, idx, cond_idx, style)
        d = (b16["target"] - b32["target"]).abs()
    print(f"data: bf16 vs float32 resident audio, targets: max_abs {float(d.max()):.4f} "
          f"mean_abs {float(d.mean()):.5f} (log power; target mean "
          f"{float(b32['target'].mean()):.4f})")
    del store32, b32, b16, d

    def counts():
        return dk.LAUNCHES["dropout_apply"], dk.LAUNCHES["dropout_grad"]

    dk.reset_launches()  # counts from here on are the resident path's
    steps = n // 16
    loss = tr.train_epoch_resident(store, epoch=0)
    check(counts() == (10 * steps, 10 * steps),
          f"resident epoch of {steps} steps: dropout launches {counts()}")
    test_loss = tr.evaluate_resident(test_store)
    check(counts() == (10 * steps, 10 * steps), "evaluate_resident launched the dropout kernel")
    check(bool(np.isfinite([loss, test_loss]).all()), "resident losses not finite")
    launches = sum(counts())
    print(f"data: train_epoch_resident ({steps} steps) loss {loss:.6f}, evaluate_resident "
          f"({test_store.n_data} chunks) mse {test_loss:.6f}; dropout launches {dict(dk.LAUNCHES)}")

    resident = epoch_rate(torch, bt, lambda: tr.train_epoch_resident(store, 0), steps,
                          "resident epochs (bf16 store)")
    fed = epoch_rate(torch, bt, lambda: tr.train_epoch(ds, 0, log_every=10**9), steps,
                     "host-fed epochs (native assembler, page-locked slots)")
    asm.close()
    return launches, resident, fed


# ---- phase 14: the store at MusicNet-piano scale ------------------------------

SCALE_CHUNKS, SCALE_STYLES = 1700, ("cuba", "aliciakeys", "gentleman", "harpsichord", "upright")


def scale_phase(torch, dk, tr):
    """Phase 14: a bf16 store of 1,700 chunks x 5 styles made on the card,
    and the warm resident step at batch 16 beside the full-width model."""
    from ml_music_style_transfer_tpu_torch.data.device_store import DeviceDataStore
    from ml_music_style_transfer_tpu_torch.scripts import bench_train as bt

    gen = torch.Generator(device="cuda").manual_seed(14)
    raw = {"pianoroll": (torch.rand((SCALE_CHUNKS, 860, 128), generator=gen, device="cuda")
                         < 0.05).to(torch.int8),
           "onoff": torch.randint(-1, 2, (SCALE_CHUNKS, 860, 128), generator=gen,
                                  device="cuda", dtype=torch.int8)}
    for s in SCALE_STYLES:
        raw[f"audio_{s}"] = 0.05 * torch.randn((SCALE_CHUNKS, 219904), generator=gen,
                                               device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t = time.perf_counter()
    store = DeviceDataStore.from_arrays(raw, seed=0)
    torch.cuda.synchronize()
    del raw
    hbm = store.hbm_bytes()
    audio_bytes = store.audio.numel() * store.audio.element_size()
    print(f"scale: DeviceDataStore {tuple(store.audio.shape)} {store.audio.dtype} + int8 rolls "
          f"built in {time.perf_counter() - t:.2f} s: hbm_bytes={hbm} ({hbm / 1e9:.3f} GB; audio "
          f"{audio_bytes / 1e9:.3f} GB, rolls {(hbm - audio_bytes) / 1e9:.3f} GB)")
    check(audio_bytes == 5 * SCALE_CHUNKS * 219904 * 2, "store audio size")
    torch.cuda.reset_peak_memory_stats()
    dk.reset_launches()  # counts from here on are this phase's resident steps
    plan = store.draw_epoch_indices(16)
    idx = [next(plan) for _ in range(15)]
    times, losses = [], []
    for i, (a, b, c) in enumerate(idx[:12]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(tr.train_step_resident(store.audio, store.pianoroll, store.onoff,
                                                   a, b, c, tr.next_dropout_seed())))
        times.append(time.perf_counter() - t)
    step_s = statistics.median(times[2:])
    peak = torch.cuda.max_memory_allocated()
    check(bool(np.isfinite(losses).all()), "scale phase: loss not finite")
    check(dk.LAUNCHES["dropout_apply"] == dk.LAUNCHES["dropout_grad"] == 120,
          f"scale phase: dropout launches {dict(dk.LAUNCHES)} after 12 steps")
    launches = dk.LAUNCHES["dropout_apply"] + dk.LAUNCHES["dropout_grad"]
    dev_ms = bt.device_ms_per_step(lambda: [
        tr.train_step_resident(store.audio, store.pianoroll, store.onoff, a, b, c, 7)
        for a, b, c in idx[12:]], 3)
    print(f"scale: warm resident step (batch 16, {SCALE_CHUNKS} x {len(SCALE_STYLES)} store) "
          f"times s {[round(x, 4) for x in times]}: median {step_s:.4f} s, "
          f"{16 * 860 / step_s:.0f} frames/s, device {dev_ms:.2f} ms/step, busy "
          f"{100 * dev_ms / (step_s * 1e3):.1f} %, max_memory_allocated_GB={peak / 1e9:.3f} "
          f"(store {hbm / 1e9:.3f} GB + model, Adam, activations)")
    check(peak < 80e9, "scale phase does not fit the card")
    del store
    return launches, dict(step_s=step_s, device_ms=dev_ms, peak=peak)


# ---- phase 12: fused conv kernel vs plain, and against cuDNN ----------------

FULL_FORWARD_BLOCKS = 64  # conv1x3 -> IN -> LReLU launches of one full-width forward
# float32 checks: midi L0, up_3.conv1 (1280 -> 1024 @860) and audio L4
FUSED_F32_BLOCKS = ("down_convs.0.conv1", "up_convs.3.conv1", "down_convs_audio.4.conv1")
FUSED_TIMED_BLOCK = "down_convs_audio.0.conv2"  # the largest: 1536 -> 1536 @860


def sass_counts(lib_path: str) -> dict:
    """Instructions in a built library's SASS (``cuobjdump -sass``, beside
    nvcc): wgmma (HGMMA), TMA loads (UTMALDG), mma.sync (HMMA) and
    cp.async (LDGSTS)."""
    import re

    from ml_music_style_transfer_tpu_torch.ops.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    ops = re.findall(r"\b(HGMMA|UTMALDG|HMMA|LDGSTS)\b", sass)
    return {op: ops.count(op) for op in ("HGMMA", "UTMALDG", "HMMA", "LDGSTS")}


def fused_conv_phase(torch, fc):
    """K1 at every distinct conv-block shape of the full-width model at
    batch 16: its SASS, then one forward's 64 blocks through the wrapper
    (the count of launches read right after), then the kernel against its
    plain version (bfloat16 at all shapes, float32 at three) and its time
    beside the plain version's, the cuDNN composite's and its bound."""
    from ml_music_style_transfer_tpu_torch.config import ModelConfig
    from ml_music_style_transfer_tpu_torch.ops.kernels import _build
    from ml_music_style_transfer_tpu_torch.scripts import bench_fused_conv as bench

    sass = sass_counts(_build.library_path("fused_conv"))
    print(f"fused conv SASS (libfused_conv.so): {sass}")
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          "libfused_conv.so has no wgmma (HGMMA) or no TMA load (UTMALDG)")
    check(sass["HMMA"] == 0 and sass["LDGSTS"] == 0,
          "libfused_conv.so still holds mma.sync (HMMA) or cp.async (LDGSTS)")

    blocks = fc.model_layer_shapes(ModelConfig(), 16)
    first = {}
    for blk in blocks:
        first.setdefault(blk.shape, blk.name)
    print(f"fused conv: {len(blocks)} blocks, {sum(b.launches for b in blocks)} launches, "
          f"{len(first)} distinct shapes, "
          f"{sum(6 * b.batch * b.t * b.cin * b.cout * b.launches for b in blocks) / 1e12:.3f} "
          "TFLOP per forward at batch 16")
    gen = torch.Generator(device="cuda").manual_seed(8)

    def inputs(shape, dtype):
        B, T, cin, cout = shape
        x = torch.randn((B, T, cin), device="cuda", generator=gen).to(dtype)
        w = (torch.randn((3, cin, cout), device="cuda", generator=gen) / (3 * cin) ** 0.5).to(dtype)
        return x, w, torch.randn(cout, device="cuda", generator=gen)

    data = {shape: inputs(shape, torch.bfloat16) for shape in first}
    fc.reset_launches()  # counts from here on are the fused-conv path's
    t = time.perf_counter()
    with torch.no_grad():
        for blk in blocks:
            for _ in range(blk.launches):
                y = fc.conv1x3_instnorm_lrelu(*data[blk.shape])
        torch.cuda.synchronize()
    launches = fc.LAUNCHES["conv1x3_instnorm_lrelu"]
    print(f"fused conv path: one full-width forward's blocks in {time.perf_counter() - t:.3f} s "
          f"(first launches), {launches} kernel launches")
    check(launches == FULL_FORWARD_BLOCKS, f"fused conv: {launches} launches, "
          f"expected {FULL_FORWARD_BLOCKS}")
    check(bool(torch.isfinite(y.float()).all()), "fused conv output not finite")

    err_bf16 = 0.0
    with torch.no_grad():
        for shape, name in first.items():
            x, w, b = data[shape]
            got = fc.conv1x3_instnorm_lrelu(x, w, b).float()
            want = fc.conv1x3_instnorm_lrelu_reference(x, w, b).float()
            diff = (got - want).abs()
            n_bad = int((diff > 2.0**-7 * want.abs() + 1e-3).sum())
            e = float(diff.max())
            err_bf16 = max(err_bf16, e)
            print(f"fused conv bf16 {name} {shape}: max_abs_err={e:.3e} outside tolerance {n_bad}")
            check(n_bad == 0, f"fused conv kernel disagrees at {name} {shape} (bf16)")
        err_f32 = 0.0
        for name in FUSED_F32_BLOCKS:
            shape = next(b.shape for b in blocks if b.name == name)
            x, w, b = inputs(shape, torch.float32)
            e = float((fc.conv1x3_instnorm_lrelu(x, w, b)
                       - fc.conv1x3_instnorm_lrelu_reference(x, w, b)).abs().max())
            err_f32 = max(err_f32, e)
            print(f"fused conv f32 {name} {shape}: max_abs_err={e:.3e} (tolerance 2e-4)")
            check(e <= 2e-4, f"fused conv kernel disagrees at {name} {shape} (f32)")
            del x, w, b
    print("fused conv tolerance, bf16: |kernel - plain| <= 2^-7 |plain| + 1e-3 per element "
          "(one bf16 rounding step; both sum exact bf16 products in f32, in other orders)")

    rows = {}
    with torch.no_grad():
        for shape, name in first.items():
            r = bench.measure(*data[shape])
            n_bytes, gemm, norm = bench.block_work(*shape, torch.bfloat16)
            r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, norm, n_bf16_flops=gemm)
            rows[shape] = r
            print(f"timing fused conv {name} {shape}: kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} cudnn_ms={r['library_ms']:.4f} "
                  f"cudnn/kernel={r['library_ms'] / r['ms']:.3f} ctas={r['ctas']} "
                  f"bound_us={r['bound_ms'] * 1e3:.2f} ({r['bound_by']}) "
                  f"of_bound={100 * r['bound_ms'] / r['ms']:.1f}%", flush=True)
    tot = bench.weighted_total(blocks, rows)
    print(f"fused conv, one full-width forward ({FULL_FORWARD_BLOCKS} launches, batch 16, bf16): "
          f"kernel_ms={tot['ms']:.3f} cudnn_composite_ms={tot['library_ms']:.3f} "
          f"bound_ms={tot['bound_ms']:.3f} kernel/cudnn={tot['ms'] / tot['library_ms']:.3f} "
          f"of_bound={100 * tot['bound_ms'] / tot['ms']:.1f}%")
    slowest = min(first, key=lambda sh: rows[sh]["library_ms"] / rows[sh]["ms"])
    print(f"fused conv, against cuDNN in this run: the kernel's least lead is at {first[slowest]} "
          f"{slowest} (cudnn/kernel={rows[slowest]['library_ms'] / rows[slowest]['ms']:.3f}); "
          f"shapes where cuDNN is faster: "
          f"{sum(rows[sh]['library_ms'] < rows[sh]['ms'] for sh in first)} of {len(first)}")
    print("library_ms for the fused conv: the cuDNN composite F.conv1d -> F.instance_norm -> "
          "F.leaky_relu on (B, C, T); no single PyTorch call computes the block")
    timed = rows[next(b.shape for b in blocks if b.name == FUSED_TIMED_BLOCK)]
    return launches, max(err_bf16, err_f32), timed


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    # float32 results are compared below: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ml_music_style_transfer_tpu_torch.infer import synthesize as synth_mod
    from ml_music_style_transfer_tpu_torch.ops import stft as tstft
    from ml_music_style_transfer_tpu_torch.ops.kernels import _build
    from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as dk
    from ml_music_style_transfer_tpu_torch.ops.kernels import fused_conv as fc
    from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue as glue
    from ml_music_style_transfer_tpu_torch.scripts import bench_inference as binf

    smi = binf.smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; "
          "allow_tf32 matmul=False cudnn=False")

    secs = _build.build_all()
    print(f"build: {secs:.2f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line.lower():
                print(f"ptxas {name}: {line.strip()}")

    errs, timing = kernel_phase(torch, glue, tstft)
    fc.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        launches, warm, state = main_path(torch, glue, dk, binf, tmp)
        profile_phase(torch, warm)
        cfg = warm.model_cfg

        def make_synth(midi, wav):  # the serving cache's model for `state`
            return synth_mod.AudioSynthesizer(tmp, midi, wav, model_cfg=cfg, params=state,
                                              device="cuda")

        gl_launches = sum(launches.values()) // 2
        gl_launches += whole_clip_phase(torch, glue, tstft, binf, make_synth, tmp, errs)
        gl_launches += batch_phase(torch, glue, binf, make_synth, tmp)
        gl_launches += daemon_phase(torch, glue, binf, make_synth, tmp)
        gl_launches += dft_phase(torch, glue, tstft, binf, warm, tmp)
        print(f"launches of each glue kernel over the serving paths (tiled, whole clip, batch, "
              f"daemon, dft): {gl_launches}")
    del warm, state, make_synth  # the serving model's 2.9 GB go back before training
    synth_mod.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    check(not any(fc.LAUNCHES.values()), "serving launched the fused conv kernel")
    dropout_err, dropout_t = dropout_phase(torch, dk)
    dropout_launches, tr, fed_step = train_phase(torch, dk, glue)
    glue.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        data_launches, resident, fed = data_phase(torch, dk, tr, tmp)
    scale_launches, scale = scale_phase(torch, dk, tr)
    check(not any(glue.LAUNCHES.values()), "the data path launched the Griffin-Lim glue")
    dropout_launches += data_launches + scale_launches
    print(f"train step at batch 16, full width, bf16: phase 11 on a staged batch "
          f"{fed_step['step_s']:.4f} s (device {fed_step['device_ms']:.2f} ms, busy "
          f"{100 * fed_step['device_ms'] / (fed_step['step_s'] * 1e3):.1f} %); host-fed epochs "
          f"{fed['step_s']:.4f} s (busy {100 * fed['device_ms'] / (fed['step_s'] * 1e3):.1f} %); "
          f"resident epochs {resident['step_s']:.4f} s (busy "
          f"{100 * resident['device_ms'] / (resident['step_s'] * 1e3):.1f} %); resident beside "
          f"the 1,700 x 5 store {scale['step_s']:.4f} s (busy "
          f"{100 * scale['device_ms'] / (scale['step_s'] * 1e3):.1f} %)")
    from ml_music_style_transfer_tpu_torch.scripts import bench_train as bt

    cuda = torch.device("cuda")
    for data, r in (("host", fed), ("resident", scale)):
        extra = dict(data=data, batch=16, width_mult=1.0, params=FULL_WIDTH_PARAMS)
        print(binf.metric_line("train_step_spectrogram_frames_per_sec_per_chip",
                               16 * 860 / r["step_s"], "frames/s", cuda, **extra))
        print(binf.metric_line("train_step_s", r["step_s"], "s", cuda, **extra))
        print(binf.metric_line("train_step_device_busy_share",
                               r["device_ms"] / (r["step_s"] * 1e3), "", cuda,
                               device_ms_per_step=round(r["device_ms"], 3), **extra))
        print(binf.metric_line("train_step_peak_memory_GB", r["peak"] / 1e9, "GB", cuda, **extra))
    print(binf.metric_line("preprocess_frames_per_sec", bt.preprocess_frames_per_sec(cuda),
                           "frames/s", cuda, chunks=bt.PREPROCESS_CHUNKS, backend="device"))
    check(not any(fc.LAUNCHES.values()), "training launched the fused conv kernel")
    print("fused conv kernel launches on the serving, training and data paths: 0 (the model "
          "keeps cuDNN's conv, as the JAX model keeps XLA's)")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    conv_launches, conv_err, conv_t = fused_conv_phase(torch, fc)

    kernels = []
    for name, src_line in (("gl_ola_nola", "ml_music_style_transfer_tpu/ops/pallas/gl_glue.py:95"),
                           ("gl_frame_window", "ml_music_style_transfer_tpu/ops/pallas/gl_glue.py:110")):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ml_music_style_transfer_tpu_torch/csrc/gl_glue.cu",
            "replaces": src_line, "launches": gl_launches,
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None})
    kernels.append({
        "name": "philox_dropout", "route": "cuda",
        "source": "ml_music_style_transfer_tpu_torch/csrc/dropout.cu",
        "replaces": "ml_music_style_transfer_tpu/ops/pallas/dropout.py:94",
        "launches": dropout_launches, "max_abs_err": dropout_err,
        "ms": dropout_t["ms"], "plain_ms": dropout_t["plain_ms"],
        "bound_ms": dropout_t["bound"][0], "bound_by": dropout_t["bound"][1],
        "library_ms": dropout_t["library_ms"]})
    kernels.append({
        "name": "conv1x3_instnorm_lrelu", "route": "cuda",
        "source": "ml_music_style_transfer_tpu_torch/csrc/fused_conv.cu",
        "replaces": "ml_music_style_transfer_tpu/ops/pallas/fused_conv.py:117",
        "launches": conv_launches, "max_abs_err": conv_err,
        "ms": conv_t["ms"], "plain_ms": conv_t["plain_ms"],
        "bound_ms": conv_t["bound_ms"], "bound_by": conv_t["bound_by"],
        "library_ms": conv_t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
