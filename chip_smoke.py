#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and data paths, its
optimizer options and checkpoints, the autoencoder family, its deployment
programs, support code and daemon soak, its multi-device layer, its sharded
asynchronous checkpoints, WAV decoder and profile scripts, its orbax
checkpoints (on one device and on a mesh), Griffin-Lim's dispatch by shape
and the bench scripts, and its fused conv-block kernel on one NVIDIA GPU
and check them. Each phase
prints its seconds.

    python3 chip_smoke.py

Imports only the port (``ml_music_style_transfer_tpu_torch``), torch, numpy,
scipy and the standard library. Phases, each reported on its own lines:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for every float32 comparison below;
  2. build: compile the CUDA kernels from ``ml_music_style_transfer_tpu_torch/csrc``
     and the operator library that registers them (``csrc/mmst_ops.cpp``);
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
     thresholds and the backward of ``dropout`` (the operator); the kernel's time
     at (16, 384, 860) beside its plain version's, ``F.dropout``'s and its
     bound;
  10b. relayout kernel K4 and the channel-last step (``layout_phase``): at
     the training shapes ((64, 1536, 860) and (16, 1536, 860), the
     autoencoder's (256, 256, 860)), bf16 to f32, f32 to bf16 and bf16 to
     bf16, into each layout, and a channel band of a wider tensor, K4 must
     equal the plain cast ``x.to(dst)`` bit for bit, with one launch a
     call on its counter; its time beside PyTorch's transposing ``copy_``
     into the same layout and the same-layout cast, with its byte bound.
     Then one full-width PerformanceNet train step at batch 64 (dropout on,
     L1 loss) through the public channel-last forward must equal the
     ``forward_channel_first`` step bit for bit: the output and all 218
     gradients;
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
  15. optimizer options at full width (after phase 14's store and phase
     11's trainer are freed): a ``Trainer`` with bf16 Adam moments, bf16
     gradients, clipping at 1.0, 4 warmup steps, an EMA (0.999) and
     ``grad_accum=2`` takes four microbatch calls on seeded chunks: 10 + 10
     dropout launches per call, the weights bit-unchanged after the first,
     two updates, bf16 moments, an EMA apart from the weights; peak memory.
     ``{params, ema_params, epoch}`` is written as the JAX package's flax
     msgpack (5.86 GB), read back and uploaded (bit-equal, GB/s), then a
     30 s request is served from that file with ``use_ema`` twice (first,
     warm) and once from the same EMA weights in memory: 300 launches of
     each glue kernel per request, three equal waveforms; the file is
     deleted. Last, the train step with plain fused float32 Adam against
     compact bf16 Adam on that model, in turns (fused, compact, compact,
     fused; 10 + 10 dropout launches per step), with each optimizer step
     alone timed by CUDA events beside its bytes bound;
  16. the autoencoder family at ``bench.py``'s configuration (n_bins 128,
     width 256, batch 32, T 860, bf16): ``autoencoder_spectral_step_ms``
     by slope (12 steps minus 2, over 10), losses finite and falling over
     the timed steps, no launch of any hand-written kernel, and a profile
     of 3 steps;
  16b. Spectrogram Diffusion (``sdiff_phase``): K2 bit for bit against its
     plain version at the family's shapes, the encoders' attention
     probabilities (8, 12, 2048, 2048) float32 and bfloat16 and the
     activations (8, 2048, 768) bfloat16, mask, apply and gradient; then
     three full-width steps (409.7M parameters, batch 8, 2048 note tokens,
     256 + 256 frames) traced: finite losses, 150 + 150 K2 launches a step,
     the spans ``sdiff.notes_encoder``, ``sdiff.context_encoder``,
     ``sdiff.decoder`` and 48 ``sdiff.attention`` inside ``train.forward``,
     the counters ``notes_tokens`` and ``notes_positions`` on ``train.step``,
     the memory peak;
  17. deployment programs (``compat/program_export.py``, after phase 16, on
     the phase-4 weights): the forward (T 860, batch 1), Griffin-Lim (860
     frames, 300 iterations) and serving (8 tiles, 30 s of timbre audio)
     programs exported on the card from the meta model (seconds, file
     sizes; no parameters in any), saved, loaded and run: the forward
     within 1e-4 of each element plus 1e-4 of the peak of the live
     model's, Griffin-Lim and serving within 1e-4 of the peak of
     ``gl_steps`` and ``synthesize_waveform`` from the same initial phase,
     each program run launching each glue kernel 300 times (its glue is
     the ``mmst_torch`` operators, its loop one ``while_loop``); the
     Griffin-Lim program once more in a fresh process;
  17b. AOTInductor packages (``aoti_phase``): phase 17's Griffin-Lim
     program and its forward and serving programs exported at float32,
     compiled on the card while phase 17 runs (seconds, package bytes);
     Griffin-Lim and serving run by the C++ runner (``csrc/aoti_runner.cpp``,
     no libpython), the forward by ``compat/aoti_load.py`` in a Python that
     imports torch alone; each held to its live path at phase 17's
     tolerances or tighter (Griffin-Lim and serving at 2 iterations, their
     ``n_iter`` input; at 300 by spectral convergence), each bound shown to
     refuse a wrong result of the same run; 300 launches of each glue
     kernel per run read from the operator library's C++ counters; each
     package's warm run against the exported program's and the live
     path's; device kernels per Griffin-Lim iteration (profiler) of the
     package and the live path;
  18. support code: ``device_trace`` of a warm request names both glue
     kernels and its ``profiling.span``; six full-width train steps (batch
     16) under ``device_trace`` record their program spans, each
     ``train.step``'s device time within 5 % of CUDA events around it, no
     cuDNN layout transpose (``nchwToNhwc``/``nhwcToNchw``) among their
     kernels, 99 of 99 convolution calls a step channel-last, and K4's
     launch counter equal to the K4 kernels in the trace; two steps
     under ``nan_debugging`` (no false positive, 10 + 10 dropout launches
     seen by the mode as ``mmst_torch::dropout_apply``, the slowdown); a
     NaN in a batch's conditioning raises ``FloatingPointError`` naming the
     operator; the phase-4 weights written as a reference ``.tar`` (2.93
     GB, GB/s), read back bit-equal and served (``compat_mbr_noop=True``)
     equal to the same weights from memory;
  19. daemon soak: ``scripts/soak_daemon.run_soak`` at 40 requests with its
     asserts (isolation of the malformed requests, no cache warning, finite
     non-silent WAVs, 300 launches of each glue kernel per Griffin-Lim run,
     the novel-length probe); per-class p50/p99, requests/s, peak memory;
  20. the multi-device layer (``parallel/``) on a process group of this
     one card (NCCL; one card cannot host two NCCL ranks, so the multi-rank
     paths are held on gloo CPU ranks by the tests): a (1, 1) mesh
     ``Trainer`` with ZeRO-1 takes a step at batch 16, T 860, full width,
     bf16, and its weights must equal the plain ``Trainer``'s step from the
     same weights, batch and dropout seed, with 10 + 10 dropout launches;
     a ``.pt`` checkpoint written after two steps (width 1/4, every
     optimizer option, on one device and on the mesh with ZeRO-1) resumes
     into a fresh ``Trainer`` whose next two steps are bit-equal;
     the time-sharded forward of a 30 s clip (5,160 frames, padded) against
     ``whole_clip_forward`` in float32 (within 1e-3 of the peak) and bf16
     (mean difference at most the bf16 forward's own mean distance from
     float32), then one time-sharded train step on that clip in
     float32 against the unsharded step (loss within 1e-5, loss after one
     Adam step within 1e-3) and its gradients in float64 (relative L2
     within 1e-9);
     ``sharded_griffinlim_from_log_power`` on the clip's spectrogram
     bit-equal to ``griffinlim`` from the same phase field with 300
     launches of each glue kernel; the kernels at the shapes a mesh of
     two ranks gives them: the dropout kernel's masks bit-equal to
     ``dropout_mask_reference`` under the mesh's seed folding
     (``fold_seed`` of the data rank, and of the model rank for fc1's
     column slice) at DenseConcat's (2 data, 2 model) shapes, and one
     Schwarz block (30 iterations) of Griffin-Lim through the glue kernels
     on each of two ranks' extended slices of the clip (t_loc + 2 halo
     frames, ``gl_shard.rank_inputs``) within 1e-3 of the peak of the
     plain istft/stft path; ``synthesize_whole_clip(mesh,
     shard_gl=True)`` equal to ``shard_gl=False`` and ``bulk_griffinlim``
     over the (1, 1) mesh equal to per-clip Griffin-Lim (300 launches of
     each glue kernel per run); each part's seconds and peak memory;
  21. sharded asynchronous checkpoints at full width (``checkpoint_phase``):
     a fresh fused-Adam ``Trainer``'s 8.78 GB state written as a ``.pt``
     (seconds) and by ``save_checkpoint_sharded`` (seconds to return and to
     commit, first save and a second with the staging buffers reused);
     the steps taken while the write runs against the same steps without
     (10 + 10 dropout launches each); the restore into a fresh ``Trainer``
     bit-equal to the state at the save call; the params-only read (seconds,
     bytes) against the ``.pt``'s; a warm 30 s request served from the
     ``.dcp`` equal to the same weights from memory (300 launches of each
     glue kernel); a (1, 1) mesh ``Trainer`` with ZeRO-1 on a NCCL group of
     one restores the ``.dcp``, saves its own, and a fresh one resumes it
     with the next step bit-identical; the native WAV decoder against scipy
     (within 1e-6; ms) and the daemon's requests/s with each (60 requests
     per decoder with 30 s stereo timbres at 44.1 and 48 kHz); then
     ``scripts/profile_step.py`` and ``profile_gl.py`` at reduced counts;
  22. orbax checkpoints (``orbax_phase``), read and written without orbax,
     tensorstore or JAX (zstd by ctypes on ``libzstd.so.1``, its version
     printed): the committed JAX-written directory
     ``tests/data/orbax_jax/checkpoint-1.orbax`` bit-equal to its expected
     leaves; a fresh full-width Trainer's 8.78 GB state after two steps
     written by ``save_checkpoint_orbax`` (seconds to return and to
     commit), its params read alone (seconds, GB/s, bytes read within 1 %
     of the params' stored bytes) and the whole state read (seconds), both
     bit-equal to the state written, beside phase 21's ``.dcp``
     params-only restore; a 10 s request served from the directory through
     ``best_checkpoint`` (300 launches of each glue kernel; equal to the
     same weights served from memory); ``fit(resume=True)`` from it, one
     epoch of 2 steps on seeded chunks (20 dropout launches, finite
     losses); the phase's seconds;
  23. orbax checkpoints on a mesh (``orbax_mesh_phase``): a full-width
     fused-Adam ``Trainer`` on a (1, 1) NCCL mesh with ZeRO-1 takes two
     steps (10 + 10 dropout launches each) and saves through ``fit``'s
     mesh path, ``save_checkpoint_orbax(orbax_state)`` (seconds to return
     and to commit; one ``ocdbt.process_0/``), its whole read bit-equal to
     ``jax_state_dict``; then this process plays the 4 ranks of a (2, 2)
     ZeRO-1 mesh in turn (each rank's blocks cut on the card with the
     placements of a (2, 2) checkpoint mesh computed with no process
     group, ``write_shards``, seconds each; then ``commit``): the whole
     read bit-equal to the (1, 1) mesh's, each rank's region read
     bit-equal to its blocks with its bytes read within 1 % of the stored
     bytes of the chunks that meet them (seconds; its share of the state);
     a 10 s request served from that directory through
     ``best_checkpoint`` equal to the same weights from memory (300
     launches of each glue kernel); ``fit(resume=True)`` from it on the
     (1, 1) mesh, one epoch of 2 steps (20 dropout launches, finite
     losses);
  24. Griffin-Lim's dispatch by shape and the last scripts
     (``dispatch_scripts_phase``): each input the glue kernels do not take
     (a ``length``, ``win_length`` 1024, hops 128/512/1024, 8 and 20
     frames, a (2, 2, 1025, 20) batch) answers under the default arguments
     with 0 glue launches, within 1e-4 of the peak of the istft -> stft
     loop, and raises under ``use_pallas_glue=True``; a 1720-frame clip
     launches each glue kernel 300 times; ``stft``'s pad modes on the card
     against the CPU; then ``scripts/bench_inference.py`` (full width, a
     10 s clip, 30 iterations, the one-pass probe up to 240 s, which must
     serve 240 s), ``bench_preprocess.py`` (its full 4 songs of 90 s;
     ``auto`` within 1.25x of the best manual backend), ``bench_dft_gl.py`` (30
     iterations) and ``bench_gl_kernels.py``, each through its ``main``;
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
``scripts/bench_train.py``'s. Every launch count is read from the
operator library's counters (``csrc/mmst_ops.cpp``), the runner's from its
own process. The glue kernels' ``launches`` in the kernels' JSON record sum
their counts over phases 4, 6-9, 15 (three requests), 17 (the programs and
the live runs they are held to), 17b (the packages' runs, the timing and
profiled runs), 18, 19 (the soak), 20 (sharded Griffin-Lim, two whole
clips and two bulk clips), 21 (three requests, 120 daemon requests), 22
and 23 (two requests each) and 24 (the 1720-frame clip and the scripts'
Griffin-Lim runs; the line before phase 24 prints the sums over phases
3-23), the dropout kernel's
over phases 11 (12 steps), 13 (the resident epoch and the evaluation), 14
(12 steps), 15 (4 microbatch calls and 24 timed steps), 18 (8 steps, 2 of
them NaN-debugged), 20 (the mesh step), 21 (the steps around the
saves), 22 (the resumed epoch's 2 steps) and 23 (the mesh's 2 steps and
the resumed epoch's 2). The
line before the last is the card's name and power limit, the one before it
the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero, and
without a card the script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
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
    width (``scripts/bench_gl_kernels.dense_concat_shapes``)."""
    from ml_music_style_transfer_tpu_torch.scripts import bench_gl_kernels

    return bench_gl_kernels.dense_concat_shapes(batch)


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
    dk.dropout(x, seed, 3, rate).backward(g)
    want = g * dk.dropout_mask_reference(seed, 3, TIMED_SHAPE, rate, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    check(torch.equal(x.grad, want), "dropout's gradient != grad * mask")
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


# ---- phase 10b: relayout kernel K4 and the channel-last step -----------------

# (B, C, T) tensors K4 moves in training: PerformanceNet's widest encoder
# activations at the benchmark's batch 64 and phase 11's 16, and the
# autoencoder's at batch 256 (width 256)
RELAYOUT_SHAPES = ((64, 1536, 860), (16, 1536, 860), (256, 256, 860))
LAYOUT_STEP_BATCH = 64


def layout_phase(torch, rl):
    from ml_music_style_transfer_tpu_torch.config import ModelConfig
    from ml_music_style_transfer_tpu_torch.models import PerformanceNet

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(18)
    rl.reset_launches()
    calls = 0

    def laid(x, channel_last: bool):
        """(B, C, T) ``x`` stored channel-last or channel-first, dense."""
        return x.transpose(1, 2).contiguous().transpose(1, 2) if channel_last else x.contiguous()

    for shape in RELAYOUT_SHAPES:
        b, c, t = shape
        for src, dst in ((bf16, f32), (f32, bf16), (bf16, bf16)):
            for first in (True, False):  # into channel-first from channel-last, or back
                wide = laid(torch.randn(b, c + 3, t, device="cuda", generator=gen).to(src), first)
                for band, x in ((True, wide[:, 3:]), (False, laid(wide[:, 3:], first))):
                    y = rl.relayout(x, dst, first)
                    calls += 1
                    stored = y.is_contiguous() if first else y.transpose(1, 2).is_contiguous()
                    same = torch.equal(y, x.to(dst))
                    check(same and stored, f"relayout {shape} {src} -> {dst} channel_first="
                          f"{first} band={band}: bit-equal={same}, laid out={stored}")
                del wide, x, y
    print(f"relayout: {calls} calls at {list(RELAYOUT_SHAPES)}, bf16->f32, f32->bf16, "
          f"bf16->bf16, both ways, whole and a band: bit-equal to x.to(dst); "
          f"K4 launches {rl.LAUNCHES['relayout']}")
    check(rl.LAUNCHES["relayout"] == calls, "relayout: a call did not launch K4 once")

    for shape in RELAYOUT_SHAPES[:1] + RELAYOUT_SHAPES[2:]:
        b, c, t = shape
        for src, dst in ((bf16, f32), (f32, bf16), (bf16, bf16)):
            for first in (True, False):
                x = torch.randn(shape, device="cuda", generator=gen).to(src)
                if first:  # a channel-last input
                    x = x.transpose(1, 2).contiguous().transpose(1, 2)
                out = torch.empty(shape, dtype=dst, device="cuda") if first else \
                    torch.empty(b, t, c, dtype=dst, device="cuda").transpose(1, 2)
                n_bytes = x.numel() * (x.element_size() + out.element_size())
                k4 = cuda_ms(lambda: rl.relayout(x, dst, first), n=20)
                copy = cuda_ms(lambda: out.copy_(x), n=20)
                cast = cuda_ms(lambda: x.to(dst, copy=True), n=20)
                bound = n_bytes / HBM_BYTES_PER_S * 1e3
                print(f"timing relayout {shape} {str(src)[6:]}->{str(dst)[6:]} to "
                      f"{'channel-first' if first else 'channel-last'}: K4 {k4:.4f} ms "
                      f"({100 * bound / k4:.1f} % of the {bound:.4f} ms byte bound), "
                      f"transposing copy_ {copy:.4f} ms ({100 * bound / copy:.1f} %), "
                      f"same-layout cast {cast:.4f} ms ({100 * bound / cast:.1f} %)")
        del x, out
    torch.cuda.empty_cache()

    # one full-width train step at batch 64, channel-last against channel-first
    model = PerformanceNet(ModelConfig(), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    B, T = LAYOUT_STEP_BATCH, 860
    midi = (torch.rand(B, T, 128, device="cuda", generator=gen) < 0.05).float()
    spec = torch.rand(B, 1025, T, device="cuda", generator=gen).transpose(1, 2) * 4
    onoff = torch.randint(-1, 2, (B, T, 128), device="cuda", generator=gen).float()
    target = torch.rand(B, 1025, T, device="cuda", generator=gen).transpose(1, 2)

    def step(channel_first: bool):
        model.zero_grad(set_to_none=True)
        if channel_first:
            pred = model.forward_channel_first(
                *(v.transpose(1, 2).contiguous() for v in (midi, spec, onoff)),
                deterministic=False, dropout_seed=DROPOUT_SEED).transpose(1, 2)
        else:
            pred = model(midi, spec, onoff, deterministic=False, dropout_seed=DROPOUT_SEED)
        (pred - target).abs().mean().backward()
        return pred.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}

    pl, gl = step(False)
    pc, gc_ = step(True)
    differ = [k for k in gc_ if not torch.equal(gc_[k], gl[k])]
    same = torch.equal(pl, pc)
    print(f"channel-last step at full width, batch {B}: output bit-equal={same}, "
          f"{len(gc_) - len(differ)} of {len(gc_)} gradients bit-equal to the channel-first "
          f"step's{'; differing: ' + ', '.join(differ[:8]) if differ else ''}")
    check(same and not differ and len(gc_) == 218,
          "the channel-last train step is not the channel-first one bit for bit")
    del model, pl, pc, gl, gc_
    torch.cuda.empty_cache()


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


# ---- phase 15: the optimizer options at full width ----------------------------

OPTIONS = dict(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16", grads_dtype="bfloat16",
               grad_clip_norm=1.0, warmup_steps=4, ema_decay=0.999, grad_accum=2)
TIMED_STEPS = 6  # per optimizer in each of four turns; the first two of each are not used


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def options_phase(torch, dk, glue, binf, tmp):
    """Phase 15: a Trainer with every optimizer option at full width, bf16,
    batch 16: four microbatch calls (two updates), the first leaving every
    weight bit-unchanged; peak memory; the train step with plain fused
    Adam against compact bf16 Adam on one model, in turns; the
    {params, ema_params, epoch} msgpack written, read back bit-equal and
    timed, then served from the file with use_ema (a warm 30 s request,
    300 launches of each glue kernel) and held equal to the same EMA
    weights served from memory. Returns (dropout launches, glue launches
    per kernel)."""
    from ml_music_style_transfer_tpu_torch.compat.weights import to_jax_params
    from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
    from ml_music_style_transfer_tpu_torch.data.audio_io import write_wav
    from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
    from ml_music_style_transfer_tpu_torch.infer import synthesize as synth_mod
    from ml_music_style_transfer_tpu_torch.midi import Note
    from ml_music_style_transfer_tpu_torch.midi import writer as midi_writer
    from ml_music_style_transfer_tpu_torch.scripts.bench_train import host_arrays
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train import optim
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer, device_prefetch

    cuda = torch.device("cuda")
    cfg = TrainConfig(batch_size=16, seed=0, **OPTIONS)
    tr = Trainer(ModelConfig(), cfg, device="cuda")
    tr.init_state(0)
    opt = tr.optimizer
    check(isinstance(opt, optim.TrainOptimizer) and isinstance(opt.adam, optim.CompactAdam),
          f"options: optimizer {type(opt).__name__} is not the compact chain")
    params = list(tr.model.parameters())
    ds = ChunkDataset.from_arrays(host_arrays(32, seed=15), seed=0)
    batches = list(device_prefetch(ds.epoch_batches(16), cuda))
    w0 = [p.detach().clone() for p in params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dk.reset_launches()
    times, losses = [], []
    for i in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(tr.train_step(batches[i % 2], tr.next_dropout_seed())))
        times.append(time.perf_counter() - t)
        got = (dk.LAUNCHES["dropout_apply"], dk.LAUNCHES["dropout_grad"])
        check(got == (10 * (i + 1),) * 2, f"options call {i}: dropout launches {got}, want 10 + 10 "
              "per microbatch call")
        if i == 0:
            check(all(torch.equal(p, w) for p, w in zip(params, w0)),
                  "options: the first microbatch call changed the weights")
        if i == 1:
            check(not all(torch.equal(p, w) for p, w in zip(params, w0)),
                  "options: the second microbatch call applied no update")
    del w0
    peak = torch.cuda.max_memory_allocated()
    launches = dk.LAUNCHES["dropout_apply"] + dk.LAUNCHES["dropout_grad"]
    count, mu, nu = opt.moments()
    ema = optim.get_param_ema(opt)
    ema_gap = max(float((e - p.detach()).abs().max()) for e, p in zip(ema, params))
    print(f"options: {OPTIONS}: 4 microbatch calls losses {[round(x, 6) for x in losses]}, "
          f"s {[round(x, 4) for x in times]} (calls 1 and 3 accumulate, 2 and 4 apply); "
          f"updates {count}, warmup count {opt.warmup_count}, mini-step {opt.mini_step}; "
          f"moments {mu[0].dtype}/{nu[0].dtype}; max |ema - params| {ema_gap:.3e}; "
          f"max_memory_allocated_GB={peak / 1e9:.3f}")
    check(bool(np.isfinite(losses).all()), "options: loss not finite")
    check(count == 2 and opt.warmup_count == 2 and opt.mini_step == 0,
          f"options: {count} updates, warmup count {opt.warmup_count}, mini-step {opt.mini_step}")
    check(all(m.dtype == torch.bfloat16 for m in mu + nu), "options: moments are not bf16")
    check(ema_gap > 0.0, "options: the EMA equals the weights")
    print(binf.metric_line("train_step_peak_memory_GB", peak / 1e9, "GB", cuda, batch=16,
                           width_mult=1.0, options="all"))

    # {params, ema_params, epoch} as the JAX package's msgpack, read back
    state = {"params": to_jax_params(tr.model.state_dict()),
             "ema_params": to_jax_params(tr.ema_state_dict()), "epoch": 1}
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = ckpt.save_checkpoint(tmp, 1, state, fmt="msgpack")
    write_s = time.perf_counter() - t
    size = os.path.getsize(path)
    t = time.perf_counter()
    back = [x.to(cuda) if isinstance(x, torch.Tensor) else x
            for x in _leaves(ckpt.restore_checkpoint(path))]
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t
    want = list(_leaves(state))
    check(len(back) == len(want) and all(
        (torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b)
        for a, b in zip(back, want)), "options: msgpack read back differs")
    print(f"options: msgpack {{params, ema_params, epoch}} {size} bytes ({size / 1e9:.3f} GB): "
          f"written in {write_s:.3f} s ({size / 1e9 / write_s:.3f} GB/s), read and uploaded in "
          f"{read_s:.3f} s ({size / 1e9 / read_s:.3f} GB/s), bit-equal")
    print(binf.metric_line("msgpack_read_GB_per_s", size / 1e9 / read_s, "GB/s", cuda,
                           bytes=size, what="read + upload to the card"))
    del back, want, state

    # the EMA weights served from the file and from memory
    rng = np.random.default_rng(15)
    notes = make_song(rng, 30.0, Note)
    midi, wav = os.path.join(tmp, "ema.mid"), os.path.join(tmp, "ema.wav")
    midi_writer.save(midi, notes)
    write_wav(wav, render(notes, 30.0))
    synth_mod.clear_caches()
    gl = 0
    t = time.perf_counter()
    from_file = synth_mod.AudioSynthesizer(tmp, midi, wav, model_cfg=ModelConfig(),
                                           checkpoint_path=path, use_ema=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    waves = {}
    for what, synth in (("file, first", from_file), ("file, warm", from_file),
                        ("memory", synth_mod.AudioSynthesizer(
                            tmp, midi, wav, model_cfg=ModelConfig(), params=tr.ema_state_dict(),
                            device="cuda"))):
        glue.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        waves[what] = synth.synthesize_waveform(n_iter=N_ITER)
        dt = time.perf_counter() - t
        gl += counted(glue, N_ITER, f"options: EMA request ({what})")
        print(f"options: 30 s request, use_ema, weights from {what}: {dt:.4f} s")
        if what == "file, warm":
            print(binf.metric_line("serving_s_per_30s_clip", dt, "s", cuda, midi_s=30.0,
                                   n_iter=N_ITER, request="use_ema from msgpack (warm)"))
    os.remove(path)
    y = waves["file, warm"]
    check(y.shape == (midi_frames(midi) * 256,) and bool(np.isfinite(y).all()),
          "options: EMA waveform shape or values")
    check(np.array_equal(y, waves["memory"]) and np.array_equal(y, waves["file, first"]),
          "options: the EMA served from the msgpack differs from the EMA served from memory")
    print(f"options: served the EMA weights from the msgpack (model built in {load_s:.3f} s, "
          "only 'ema_params' read): waveform equal to the same EMA served from memory")
    synth_mod.clear_caches()
    del from_file, synth

    # the train step, plain fused float32 Adam against compact bf16 Adam,
    # on this model, in turns
    named = list(tr.model.named_parameters())
    optimizers = {"fused": optim.build_optimizer(named, TrainConfig(), 1e-3, cuda),
                  "compact": optim.build_optimizer(
                      named, TrainConfig(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16"),
                      1e-3, cuda)}
    step_s = {k: [] for k in optimizers}
    opt_ms = {k: [] for k in optimizers}
    dk.reset_launches()
    for name in ("fused", "compact", "compact", "fused"):
        tr.optimizer = optimizers[name]
        for i in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.train_step(batches[0], tr.next_dropout_seed())
            torch.cuda.synchronize()
            if i >= 2:
                step_s[name].append(time.perf_counter() - t)
        opt_ms[name].append(cuda_ms(tr.optimizer.step, n=10, warmup=2))
    # read g, p, m, v and write p, m, v once: 7 x 4 B per parameter in
    # float32, 4 + 4 + 2 + 2 + 4 + 2 + 2 = 20 B with bf16 moments
    n_params = sum(p.numel() for p in tr.model.parameters())
    opt_bound = {"fused": bound_ms(28 * n_params, 0)[0], "compact": bound_ms(20 * n_params, 0)[0]}
    n_steps = 4 * TIMED_STEPS
    check(dk.LAUNCHES["dropout_apply"] == dk.LAUNCHES["dropout_grad"] == 10 * n_steps,
          f"options: dropout launches {dict(dk.LAUNCHES)} after {n_steps} timed steps")
    launches += 20 * n_steps
    med = {k: statistics.median(v) for k, v in step_s.items()}
    print(f"options: train step (batch 16, full width, bf16) fused f32 Adam {med['fused']:.4f} s "
          f"(steps {[round(x, 4) for x in step_s['fused']]}) vs compact bf16 Adam "
          f"{med['compact']:.4f} s (steps {[round(x, 4) for x in step_s['compact']]}); "
          f"optimizer step alone (CUDA events, 10 steps) fused "
          f"{[round(x, 3) for x in opt_ms['fused']]} ms vs compact "
          f"{[round(x, 3) for x in opt_ms['compact']]} ms (bytes bounds {opt_bound['fused']:.3f} "
          f"and {opt_bound['compact']:.3f} ms at 28 and 20 B per parameter)")
    for name, dt in (("fused", "float32"), ("compact", "bfloat16")):
        print(binf.metric_line("train_step_s", med[name], "s", cuda, batch=16, width_mult=1.0,
                               adam_mu_dtype=dt, adam_nu_dtype=dt, grads_dtype="float32",
                               optimizer_step_ms=round(statistics.median(opt_ms[name]), 3)))
    del tr, optimizers, opt, mu, nu, ema, params, named, batches
    return launches, gl


# ---- phase 16: the autoencoder family -------------------------------------------

def autoencoder_phase(torch, dk, glue, fc, binf):
    """Phase 16: ``bench.py``'s autoencoder extra (n_bins 128, width 256,
    batch 32, T 860, bf16) through ``bench_train.autoencoder_step_ms``:
    finite losses that fall over the timed steps, no launch of any
    hand-written kernel (the JAX autoencoder reaches no Pallas kernel)."""
    from ml_music_style_transfer_tpu_torch.scripts import bench_train as bt

    cuda = torch.device("cuda")
    for mod in (dk, glue, fc):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    r = bt.autoencoder_step_ms(cuda)
    peak = torch.cuda.max_memory_allocated()
    ls = r["losses"]
    print(f"autoencoder: SpectrogramAutoencoder(n_bins={bt.AE_BINS}, width={bt.AE_WIDTH}) "
          f"params={r['params']}, batch {bt.AE_BATCH}, T {bt.AE_T}, bf16: "
          f"{r['ms']:.3f} ms per step (slope of 12 vs 2 steps), losses {ls[0]:.6f} -> {ls[-1]:.6f} "
          f"over the timed steps, max_memory_allocated_GB={peak / 1e9:.3f}")
    check(bool(np.isfinite(ls).all()), "autoencoder: loss not finite")
    check(ls[-1] < ls[0], f"autoencoder: loss did not fall: {ls[0]} -> {ls[-1]}")
    for mod in (dk, glue, fc):
        check(not any(mod.LAUNCHES.values()), f"autoencoder launched {dict(mod.LAUNCHES)}")
    print("autoencoder: hand-written kernel launches 0 (fused conv, dropout, Griffin-Lim glue)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            r["step"]()
        torch.cuda.synchronize()
    rows = sorted(((dev_us(e) / 3e3, e.count // 3, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False) and "#" not in e.key),
                  reverse=True)
    device_ms = sum(ms for ms, _, _ in rows)
    print(f"autoencoder: profile (3 steps): device {device_ms:.3f} ms/step in "
          f"{sum(c for _, c, _ in rows)} kernels and copies, busy "
          f"{100 * device_ms / r['ms']:.1f} % of the slope-timed step")
    for ms, count, key in rows[:8]:
        print(f"autoencoder: profile {ms:8.3f} ms/step {100 * ms / device_ms:5.1f} % x{count:<4d} "
              f"{key[:90]}")
    print(binf.metric_line("autoencoder_spectral_step_ms", r["ms"], "ms", cuda, n_bins=bt.AE_BINS,
                           width=bt.AE_WIDTH, batch=bt.AE_BATCH, t=bt.AE_T, params=r["params"],
                           dtype="bfloat16"))


# ---- phase 16b: Spectrogram Diffusion ---------------------------------------------

SDIFF_K2_SHAPES = (((8, 12, 2048, 2048), "float32"), ((8, 12, 2048, 2048), "bfloat16"),
                   ((8, 2048, 768), "bfloat16"))
SDIFF_BATCH = 8


def sdiff_phase(torch, dk):
    """Phase 16b: K2 at the family's shapes bit for bit, then traced full-
    width steps with their spans, counters and launches."""
    from ml_music_style_transfer_tpu_torch.midi import Note, events
    from ml_music_style_transfer_tpu_torch.models import spectrogram_diffusion as sd
    from ml_music_style_transfer_tpu_torch.utils import profiling

    seed, rate = DROPOUT_SEED, 0.1
    gen = torch.Generator(device="cuda").manual_seed(16)
    for ci, (shape, name) in enumerate(SDIFF_K2_SHAPES):
        dtype = getattr(torch, name)
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype).requires_grad_()
        m = dk.dropout_mask(seed, ci, shape, rate, dtype)
        same = torch.equal(m, dk.dropout_mask_reference(seed, ci, shape, rate, dtype, "cuda"))
        y = dk.dropout(x, seed, ci, rate)
        same = same and torch.equal(y, x.detach() * m)
        g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        y.backward(g)
        same = same and torch.equal(x.grad, g * m)
        kept = float((m != 0).float().mean())
        print(f"sdiff: K2 {shape} {name} call {ci}: mask, apply and gradient bit-equal={same} "
              f"kept={kept:.6f}")
        check(same, f"K2 differs from its plain version at {shape} {name}")
        check(abs(kept - (1.0 - rate)) < 1e-3, f"K2 keep fraction {kept} at {shape}")
        del x, m, y, g
    torch.cuda.empty_cache()

    cfg = sd.SpectrogramDiffusionConfig()
    rng = np.random.default_rng(16)
    seg = cfg.targets_length * cfg.hop / cfg.sr
    tokens = []
    for n in (32, 48, 64, 64, 80, 96, 128, 400):
        on = rng.uniform(-0.5, seg, n)
        tokens.append(events.encode_segment(
            [Note(int(p), 100, float(s), float(s + d)) for p, s, d in
             zip(rng.integers(21, 109, n), on, rng.uniform(0.05, 1.0, n))], 0.0, seg,
            cfg.max_length))
    tokens = torch.from_numpy(np.stack(tokens))
    audio = 0.1 * torch.randn((SDIFF_BATCH, 2, (cfg.targets_length - 1) * cfg.hop),
                              device="cuda", generator=gen)
    torch.cuda.reset_peak_memory_stats()
    model = sd.SpectrogramDiffusion(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    trainer = sd.make_spectrogram_diffusion_train_step(model)
    losses = [float(trainer.step(tokens, audio, 1000 + i)) for i in range(2)]
    torch.cuda.synchronize()
    dk.reset_launches()
    profiling.clear_spans()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        losses += [float(trainer.step(tokens, audio, 1002 + i)) for i in range(3)]
    step_s = (time.perf_counter() - t0) / 3
    spans = profiling.spans()
    profiling.clear_spans()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(dk.LAUNCHES)
    steps = [r for r in spans if r.name == "train.step"]
    names = {r.name for r in spans}
    per_step = {n: sum(1 for r in spans if r.name == n) / max(len(steps), 1)
                for n in ("sdiff.attention", "sdiff.notes_encoder", "sdiff.context_encoder",
                          "sdiff.decoder", "train.forward")}
    ms = {n: statistics.median(1e3 * r.device_s for r in spans if r.name == n and r.device_s)
          for n in ("train.step", "train.forward", "train.backward", "sdiff.notes_encoder",
                    "sdiff.decoder")}
    attn_ms = sum(1e3 * r.device_s for r in spans if r.name == "sdiff.attention") / len(steps)
    counters = steps[-1].counters if steps else {}
    real = int(torch.count_nonzero(tokens))
    print(f"sdiff: SpectrogramDiffusion params={n_params}, batch {SDIFF_BATCH}, "
          f"{cfg.max_length} note tokens ({real} real), bf16: losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; traced step {step_s:.4f} s, device ms "
          f"{ {k: round(v, 2) for k, v in ms.items()} }, attention {attn_ms:.2f} ms a step; "
          f"K2 launches in 3 steps {launches}; spans a step {per_step}; counters {counters}; "
          f"max_memory_allocated_GB={peak / 1e9:.3f}")
    check(n_params == 409_699_584, f"sdiff: {n_params} parameters")
    check(bool(np.isfinite(losses).all()), "sdiff: loss not finite")
    check(launches.get("dropout_apply") == 450 and launches.get("dropout_grad") == 450,
          f"sdiff: K2 launches {launches}, want 150 + 150 a step")
    check(len(steps) == 3 and per_step["sdiff.attention"] == 48
          and all(per_step[n] == 1 for n in ("sdiff.notes_encoder", "sdiff.context_encoder",
                                             "sdiff.decoder", "train.forward")),
          f"sdiff: spans a step {per_step}")
    check({"train.input", "train.loss", "train.backward", "train.optimizer"} <= names,
          f"sdiff: spans {sorted(names)}")
    check(counters.get("notes_tokens") == real
          and counters.get("notes_positions") == tokens.numel(), f"sdiff: counters {counters}")
    del model, trainer, audio
    gc.collect()
    torch.cuda.empty_cache()


# ---- phase 17: deployment programs (torch.export) ------------------------------

FORWARD_TOL = 1e-4  # relative, plus as much of the peak; see export_phase
GL_PROGRAM_TOL = 1e-4  # of the peak
SERVING_MIDI_SECONDS = 21.0  # 8 tiles and l_out = 3870 frames, the program's shapes


def _fresh_process_program(torch, path: str, inputs_path: str, out_path: str) -> dict:
    """Load the program at ``path`` in a new Python process (the package
    imported first, as a loaded program names its ``mmst_torch`` operators),
    run it on the inputs saved at ``inputs_path`` and save its output;
    returns the glue launches that process counted."""
    code = "\n".join([
        "import json, sys, torch",
        "import ml_music_style_transfer_tpu_torch",
        "from ml_music_style_transfer_tpu_torch.compat.program_export import load_artifact",
        "from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue",
        "args = torch.load(sys.argv[2])",
        "with torch.inference_mode():",
        "    y = load_artifact(sys.argv[1]).module()(*args)",
        "torch.save(y.cpu(), sys.argv[3])",
        "print(json.dumps(dict(gl_glue.LAUNCHES)))"])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, path, inputs_path, out_path],
                         capture_output=True, text=True, timeout=600, env=env)
    check(out.returncode == 0, f"fresh-process program run failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def export_phase(torch, glue, tstft, binf, state, cfg, tmp) -> int:
    """Phase 17: the forward (T 860, batch 1), Griffin-Lim (860 frames, 300
    iterations) and serving (8 tiles, 30 s of timbre audio) programs
    exported on the card from the meta model, saved, loaded and run with
    the phase-4 weights. The forward against the live model, element by
    element within ``FORWARD_TOL`` of it plus ``FORWARD_TOL`` of the peak
    (the CPU tests' tolerance for the forward program): the program replays
    the same ATen operators at the same shapes, and with cuDNN's autotuner
    off the card picks the same algorithms, so every card run so far was
    bit-equal. Griffin-Lim and serving against ``gl_steps`` and
    ``AudioSynthesizer`` from the same initial phase (``GL_PROGRAM_TOL`` of
    the peak), each program run launching each glue kernel 300 times; the
    Griffin-Lim program once more in a fresh process. Returns the glue
    launches per kernel."""
    from ml_music_style_transfer_tpu_torch.compat import program_export as pe
    from ml_music_style_transfer_tpu_torch.data.audio_io import read_wav, write_wav
    from ml_music_style_transfer_tpu_torch.infer import synthesize as synth_mod
    from ml_music_style_transfer_tpu_torch.midi import Note
    from ml_music_style_transfer_tpu_torch.midi import writer as midi_writer
    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl

    cuda = torch.device("cuda")
    out_dir = os.path.join(tmp, "programs")
    paths = pe.write_artifacts(out_dir, cfg, device=cuda)
    with open(paths["manifest"]) as f:
        seconds = json.load(f)["export_seconds"]
    params = pe.program_params(state, cfg)
    rng = np.random.default_rng(17)  # the forward's seeded inputs
    midi = torch.from_numpy((rng.random((1, 860, 128)) < 0.05).astype(np.float32)).cuda()
    cond = torch.from_numpy(rng.random((1, 860, 1025), dtype=np.float32) * 8.0).cuda()
    onoff = torch.from_numpy(rng.integers(-1, 2, (1, 860, 128)).astype(np.float32)).cuda()
    compiling = start_package_compiles(torch, pe, paths, cfg, cuda, tmp,
                                       (params, midi, cond, onoff))
    programs = {}
    for name in ("forward", "griffinlim", "serving"):
        t = time.perf_counter()
        ep = pe.load_artifact(paths[name])
        load_s = time.perf_counter() - t
        n_const = sum(v.numel() for v in ep.constants.values())
        n_ops = sum(n.op == "call_function" for n in ep.graph.nodes)
        print(f"export: {name}.pt2 {os.path.getsize(paths[name])} bytes, exported in "
              f"{seconds[name]:.2f} s, loaded in {load_s:.2f} s, {n_ops} operator nodes, "
              f"{len(ep.constants)} constants of {n_const} elements, "
              f"{len(ep.state_dict)} parameters or buffers")
        check(not ep.state_dict and not ep.graph_signature.parameters,
              f"export: the {name} program holds parameters")
        programs[name] = ep.module()
    bodies = pe.loop_bodies(pe.load_artifact(paths["griffinlim"]))
    gl_nodes = [sum(n.target == torch.ops.mmst_torch.gl_ola_nola.default for n in b.graph.nodes)
                for b in bodies]
    check(gl_nodes == [1], f"export: gl_ola_nola nodes in the Griffin-Lim program's loop "
          f"bodies: {gl_nodes}, expected one loop of one")
    n = 0

    # forward against the live model on seeded inputs
    model = synth_mod.build_model(cfg, state, cuda)
    with torch.inference_mode():
        got = programs["forward"](params, midi, cond, onoff)
        want = model(midi, cond, onoff)
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    print(f"export: forward program vs live model (1, 860) bf16: max_abs_err={err:.3e} on a peak "
          f"of {peak:.3f} ({err / peak:.3e} of it; tolerance {FORWARD_TOL} of each element and "
          f"of the peak), bit-equal={torch.equal(got, want)}")
    check(got.shape == want.shape and bool(
        ((got - want).abs() <= FORWARD_TOL * (want.abs() + peak)).all()),
          "export: the forward program disagrees with the live model")
    del model

    # Griffin-Lim against gl_steps from the same phase, in this process and a fresh one
    spec = want[0].transpose(0, 1).contiguous()
    phase = pe.init_phase(spec.shape, 5).cuda()
    with torch.inference_mode():
        glue.reset_launches()
        t = time.perf_counter()
        y_prog = programs["griffinlim"](spec, phase, pe.iterations(N_ITER))
        torch.cuda.synchronize()
        prog_s = time.perf_counter() - t
        n += counted(glue, N_ITER, "griffinlim program")
        glue.reset_launches()
        y_live = y_live_gl = tgl.griffinlim(tstft.inverse_log_power(spec), init_phase=phase,
                                            n_iter=N_ITER, device=cuda)
        n += counted(glue, N_ITER, "griffinlim live")
    err = float((y_prog - y_live).abs().max() / y_live.abs().max())
    print(f"export: griffinlim program (860 frames, 300 iters, {prog_s:.3f} s) vs gl_steps: "
          f"max_abs_err/peak={err:.3e} (tolerance {GL_PROGRAM_TOL}), bit-equal="
          f"{torch.equal(y_prog, y_live)}")
    check(y_prog.shape == y_live.shape and err <= GL_PROGRAM_TOL,
          "export: the Griffin-Lim program disagrees with gl_steps")
    inputs_path, out_path = os.path.join(tmp, "gl_inputs.pt"), os.path.join(tmp, "gl_out.pt")
    torch.save((spec, phase, pe.iterations(N_ITER)), inputs_path)
    t = time.perf_counter()
    fresh = _fresh_process_program(torch, paths["griffinlim"], inputs_path, out_path)
    y_fresh = torch.load(out_path)
    err = float((y_fresh - y_prog.cpu()).abs().max() / y_live.abs().max())
    print(f"export: griffinlim program loaded in a fresh process ({time.perf_counter() - t:.1f} s "
          f"with its start-up): launches {fresh}, max_abs_err/peak vs this process {err:.3e}")
    check(all(v == N_ITER for v in fresh.values()) and err <= GL_PROGRAM_TOL,
          "export: the Griffin-Lim program run in a fresh process disagrees")

    # serving against AudioSynthesizer: the same request, the same phase
    notes = make_song(np.random.default_rng(17), SERVING_MIDI_SECONDS, Note)
    midi_p, wav_p = os.path.join(tmp, "export.mid"), os.path.join(tmp, "export.wav")
    midi_writer.save(midi_p, notes)
    write_wav(wav_p, render(notes, 30.0))
    synth = synth_mod.AudioSynthesizer(tmp, midi_p, wav_p, model_cfg=cfg, params=state, device=cuda)
    glue.reset_launches()
    y_live = synth.synthesize_waveform(n_iter=N_ITER)
    n += counted(glue, N_ITER, "serving live")
    roll, onoff_r, starts, t_total = synth._chunk_midi(midi_p, True)
    audio, _ = read_wav(wav_p, sr=44100)
    n_tiles, l_out = 8, pe.serving_frames(8)
    pad = n_tiles - roll.shape[0]
    check(0 <= pad < 4 and -(-t_total // GL_BUCKET) * GL_BUCKET == l_out,
          f"export: the {SERVING_MIDI_SECONDS} s request does not fill the program's shapes")
    cst = synth._cond_starts(starts, 1 + len(audio) // 256, "aligned", 860)

    def tiles(a):
        return torch.from_numpy(np.pad(a, ((0, pad), (0, 0), (0, 0)))).cuda()

    args = (params, torch.from_numpy(audio.astype(np.float32)).cuda(), tiles(roll), tiles(onoff_r),
            torch.tensor(list(starts) + [0] * pad, device=cuda),
            torch.tensor(cst + [0] * pad, device=cuda),
            torch.tensor([1.0] * roll.shape[0] + [0.0] * pad, device=cuda),
            torch.tensor(t_total, device=cuda), pe.init_phase((1025, l_out), 0).cuda(),
            pe.iterations(N_ITER))
    glue.reset_launches()
    with torch.inference_mode():
        t = time.perf_counter()
        y_prog = programs["serving"](*args)
        torch.cuda.synchronize()
        prog_s = time.perf_counter() - t
    n += counted(glue, N_ITER, "serving program")
    y_prog = y_prog[: t_total * 256].cpu().numpy()
    err = float(np.abs(y_prog - y_live).max() / np.abs(y_live).max())
    print(f"export: serving program ({roll.shape[0]} tiles + {pad} padded, 30 s audio, "
          f"{l_out} frames, {prog_s:.3f} s) vs AudioSynthesizer.synthesize_waveform: "
          f"max_abs_err/peak={err:.3e} (tolerance {GL_PROGRAM_TOL}), bit-equal="
          f"{np.array_equal(y_prog, y_live)}")
    check(err <= GL_PROGRAM_TOL, "export: the serving program disagrees with the serving path")
    del programs
    ref = {"paths": paths, "forward": ((params, midi, cond, onoff), want),
           "griffinlim": ((spec, phase, pe.iterations(N_ITER)), y_live_gl),
           "serving": (args, y_live), "t_total": t_total, "synth": synth,
           "request": (midi_p, wav_p), "compiling": compiling}
    return n, ref


# ---- phase 17b: AOTInductor packages, run without the port ------------------------

AOTI_RUNS = 3  # package runs per process: the first is cold, the others warm
# Each package runs twice: at AOTI_CHECK_ITERS Griffin-Lim iterations, held
# to the live path elementwise, and at N_ITER, the serving count (launches,
# times). 300 momentum iterations grow any rounding difference to ~1e-3 of
# the peak, so there the waveform is held by its spectral convergence.
AOTI_CHECK_ITERS = 2
AOTI_GL_TOL = 1e-5  # of the peak, at AOTI_CHECK_ITERS (PERF.md §6: readings ~1e-6)
AOTI_GL_SC = 1.001  # at N_ITER: x the live waveform's spectral convergence
AOTI_SERVING_SC = 1.01  # at N_ITER: x the live float32 serving waveform's


def start_package_compiles(torch, pe, paths: dict, cfg, cuda, tmp, fwd_args) -> dict:
    """Phase 17b's packages, compiled while phase 17 checks its programs:
    phase 17's Griffin-Lim program, and the forward and serving programs
    exported again at float32 (``compute_dtype``), where compiled code and
    the live path can be held to phase 17's tolerances (Inductor's fusions
    round bfloat16 elsewhere than the live path); the C++ runner builds
    beside them. Once compiled, the forward package runs on ``fwd_args`` by
    ``aoti_load.py`` (its process takes ~30 s to start) while phase 17b
    checks the others. Returns ``{"threads", "result", "paths32",
    "cfg32"}``; ``result`` gets the packages, the runner and the forward's
    run, or the error."""
    import threading

    from ml_music_style_transfer_tpu_torch.ops.kernels import _build

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    out_dir = os.path.join(tmp, "programs32")
    os.makedirs(out_dir, exist_ok=True)
    paths32 = {}
    for name, export in (("forward", lambda: pe.export_forward(cfg32, device=cuda)),
                         ("serving", lambda: pe.export_serving(cfg32, device=cuda))):
        t = time.perf_counter()
        paths32[name] = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(export(), paths32[name])
        print(f"aoti: {name} program exported at float32 in {time.perf_counter() - t:.2f} s")
    result: dict = {}

    def timed_into(key, fn):
        t = time.perf_counter()
        try:
            result[key] = fn()
        except Exception as e:  # reported by aoti_phase
            result["error"] = e
        result[key + "_s"] = time.perf_counter() - t

    def packages_then_forward():
        timed_into("packages", lambda: pe.compile_saved(
            {"griffinlim": paths["griffinlim"], **paths32}, os.path.join(tmp, "packages")))
        if "error" not in result:
            inputs = os.path.join(tmp, "forward_in.pt")
            pe.save_flat_inputs(inputs, *fwd_args)
            timed_into("forward_run", lambda: pe.run_package(
                result["packages"]["forward"][0], inputs, os.path.join(tmp, "forward_out.pt"),
                runs=AOTI_RUNS, runner=False))

    threads = [threading.Thread(target=packages_then_forward),
               threading.Thread(target=timed_into, args=("runner", _build.build_runner))]
    for thread in threads:
        thread.start()
    return {"threads": threads, "result": result, "paths32": paths32, "cfg32": cfg32}


def _warm_s(torch, fn, runs: int = 2) -> float:
    """Seconds of the last of ``runs`` calls of ``fn``, each ended by a sync."""
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    return time.perf_counter() - t


def _kernels_per_run(torch, fn) -> int:
    """Device kernels one call of ``fn`` launches, from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


def _of_peak(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def aoti_phase(torch, glue, tstft, ref, state, tmp) -> int:
    """Phase 17b: the packages ``start_package_compiles`` compiled on the
    card (seconds, package bytes), run without the port: Griffin-Lim and
    serving by the C++ runner (``csrc/aoti_runner.cpp``, ``ldd`` without
    libpython), the forward by ``compat/aoti_load.py`` in a Python process
    that imports torch alone (both with TF32 off, as this process). Each is
    held to its live path from the same weights and phase at phase 17's
    tolerances or tighter, and each bound is shown to refuse a wrong result
    measured in this run:
      - Griffin-Lim at ``AOTI_CHECK_ITERS`` iterations (the package's
        ``n_iter`` input) within ``AOTI_GL_TOL`` of the peak (wrong: the
        live path one iteration short); at 300, 300 launches of each glue
        kernel per run (the library's C++ counters) and a spectral
        convergence within ``AOTI_GL_SC`` times the live waveform's;
      - serving (float32) at ``AOTI_CHECK_ITERS`` within ``GL_PROGRAM_TOL``
        of the peak of ``synthesize_waveform`` (wrong: the bfloat16 serving
        path); at 300, 300 launches per run and a spectral convergence
        within ``AOTI_SERVING_SC`` times the live waveform's;
      - the forward (float32) within ``FORWARD_TOL`` of each element plus
        ``FORWARD_TOL`` of the peak of the live model (wrong: the bfloat16
        forward).
    Then each package's warm run against the ``torch.export`` program's and
    the live path's, and the device kernels per Griffin-Lim iteration in a
    profiler trace of the package and of the live path. Returns the glue
    launches per kernel (the runner's included)."""
    from ml_music_style_transfer_tpu_torch.compat import program_export as pe
    from ml_music_style_transfer_tpu_torch.infer import synthesize as synth_mod
    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl

    cuda = torch.device("cuda")
    compiling, n = ref["compiling"], 0
    print(f"aoti: Inductor options {pe.eager_numerics_configs()}")
    t = time.perf_counter()
    result = compiling["result"]
    compiling["threads"][1].join()
    while "packages_s" not in result and compiling["threads"][0].is_alive():
        time.sleep(0.5)
    check("error" not in result, f"aoti: {result.get('error')}")
    ldd = subprocess.run(["ldd", result["runner"]], capture_output=True, text=True).stdout
    print(f"aoti: runner built in {result['runner_s']:.1f} s beside the compiles; libpython "
          f"linked: {'libpython' in ldd}")
    check("libpython" not in ldd and "libmmst_ops" in ldd,
          f"aoti: the runner links libpython or not the operator library:\n{ldd}")
    pkgs = {}
    for name, (package, secs) in result["packages"].items():
        pkgs[name] = package
        print(f"aoti: {name} package compiled on the card in {secs:.1f} s (its own process), "
              f"{os.path.getsize(package)} bytes", flush=True)
    print(f"aoti: the three compiles side by side took {result['packages_s']:.1f} s (waited "
          f"{time.perf_counter() - t:.1f} s for them here)")

    def run(name: str, args, n_iter: int, runs: int, runner: bool = True):
        """The package run in a new process on ``args`` (its ``n_iter``
        input set), or for the forward the run ``start_package_compiles``
        made; returns its output on the card."""
        if name == "forward":
            compiling["threads"][0].join()
            check("error" not in result, f"aoti: {result.get('error')}")
            rep, out = result["forward_run"], os.path.join(tmp, "forward_out.pt")
            print(f"aoti: forward package run by aoti_load.py beside the checks above "
                  f"({result['forward_run_s']:.1f} s with its process's start-up)")
        else:
            inputs = os.path.join(tmp, f"{name}_{n_iter}_in.pt")
            out = os.path.join(tmp, f"{name}_{n_iter}_out.pt")
            pe.save_flat_inputs(inputs, *args[:-1], pe.iterations(n_iter))
            rep = pe.run_package(pkgs[name], inputs, out, runs=runs, runner=runner)
        check(rep["device"] == "cuda", f"aoti: the {name} package ran on {rep['device']}")
        others = {k: v for k, v in rep["launches"].items() if k not in glue.LAUNCHES
                  and any(v["cuda"] + v["cpu"])}
        glue_runs = [rep["launches"][k]["cuda"] for k in glue.LAUNCHES]
        per_run = 0 if name == "forward" else n_iter
        print(f"aoti: {name} package by {'the C++ runner' if runner else 'aoti_load.py'} at "
              f"n_iter {n_iter}: load {rep['load_s']:.2f} s, runs "
              f"{[round(x, 4) for x in rep['run_s']]} s, glue launches per run {glue_runs} "
              f"(C++ counters)", flush=True)
        check(all(r == [per_run] * runs for r in glue_runs) and not others,
              f"aoti: {name} package launches {rep['launches']}")
        if runs > 1:
            ref[name + "_package_s"] = min(rep["run_s"][1:])
        if not runner:
            check(not rep["repo_modules"], "aoti: the loader's process imported the port: "
                  f"{rep['repo_modules']}")
        return torch.load(out)[0].cuda(), per_run * runs

    # Griffin-Lim: phase 17's program (float32 throughout)
    gl_args, gl_want = ref["griffinlim"]
    spec, phase = gl_args[:2]
    mag = tstft.inverse_log_power(spec)
    glue.reset_launches()
    with torch.inference_mode():
        short = [tgl.griffinlim(mag, init_phase=phase, n_iter=k, device=cuda)
                 for k in (AOTI_CHECK_ITERS - 1, AOTI_CHECK_ITERS)]
    n += counted(glue, 2 * AOTI_CHECK_ITERS - 1, "aoti: live Griffin-Lim, short")
    got, k = run("griffinlim", gl_args, AOTI_CHECK_ITERS, 1)
    n += k
    err, wrong = _of_peak(got, short[1]), _of_peak(short[0], short[1])
    print(f"aoti: griffinlim package at n_iter {AOTI_CHECK_ITERS} vs the live path: "
          f"max_abs_err/peak={err:.3e} (bound {AOTI_GL_TOL}; the live path one iteration short: "
          f"{wrong:.3e})", flush=True)
    check(got.shape == short[1].shape and err <= AOTI_GL_TOL < wrong,
          "aoti: the griffinlim package disagrees with the live path")
    got, k = run("griffinlim", gl_args, N_ITER, AOTI_RUNS)
    n += k
    sc = [spectral_convergence(torch, tstft, y, mag) for y in (got, gl_want, short[1])]
    print(f"aoti: griffinlim package at n_iter {N_ITER}: spectral convergence {sc[0]:.6f}, live "
          f"{sc[1]:.6f} (bound {AOTI_GL_SC} x; {AOTI_CHECK_ITERS} iterations: {sc[2]:.6f}); "
          f"max_abs_err/peak vs the live path {_of_peak(got, gl_want):.3e}", flush=True)
    check(sc[0] <= AOTI_GL_SC * sc[1] < sc[2],
          "aoti: the griffinlim package synthesises worse than the live path")

    # serving at float32: the live path is AudioSynthesizer on the same request
    cfg32, t_total = compiling["cfg32"], ref["t_total"]
    midi_p, wav_p = ref["request"]
    synth32 = synth_mod.AudioSynthesizer(tmp, midi_p, wav_p, model_cfg=cfg32, params=state,
                                         device=cuda)
    s_args = ref["serving"][0]
    glue.reset_launches()
    live32 = {k: torch.from_numpy(synth32.synthesize_waveform(n_iter=k)).cuda()
              for k in (AOTI_CHECK_ITERS, N_ITER)}
    bf16 = torch.from_numpy(ref["synth"].synthesize_waveform(n_iter=AOTI_CHECK_ITERS)).cuda()
    n += counted(glue, 2 * AOTI_CHECK_ITERS + N_ITER, "aoti: live serving")
    got, k = run("serving", s_args, AOTI_CHECK_ITERS, 1)
    n += k
    got = got[: t_total * 256]
    err, wrong = _of_peak(got, live32[AOTI_CHECK_ITERS]), _of_peak(bf16, live32[AOTI_CHECK_ITERS])
    print(f"aoti: serving package (float32) at n_iter {AOTI_CHECK_ITERS} vs "
          f"AudioSynthesizer.synthesize_waveform: max_abs_err/peak={err:.3e} (bound "
          f"{GL_PROGRAM_TOL}; the bfloat16 serving path: {wrong:.3e})", flush=True)
    check(got.shape == live32[AOTI_CHECK_ITERS].shape and err <= GL_PROGRAM_TOL < wrong,
          "aoti: the serving package disagrees with the serving path")
    with torch.inference_mode():
        target = pe.serving_magnitude_fn(cfg32, 8)(*s_args[:-2])[:, :t_total]
    got, k = run("serving", s_args, N_ITER, AOTI_RUNS)
    n += k
    got = got[: t_total * 256]
    sc = [spectral_convergence(torch, tstft, y, target)
          for y in (got, live32[N_ITER], live32[AOTI_CHECK_ITERS])]
    print(f"aoti: serving package at n_iter {N_ITER}: spectral convergence {sc[0]:.6f}, live "
          f"{sc[1]:.6f} (bound {AOTI_SERVING_SC} x; {AOTI_CHECK_ITERS} iterations: {sc[2]:.6f}); "
          f"max_abs_err/peak vs the live waveform {_of_peak(got, live32[N_ITER]):.3e}",
          flush=True)
    check(sc[0] <= AOTI_SERVING_SC * sc[1] < sc[2],
          "aoti: the serving package synthesises worse than the live path")

    # forward at float32, by aoti_load.py
    fwd_args, want16 = ref["forward"]
    model32 = synth_mod.build_model(cfg32, fwd_args[0], cuda)
    with torch.inference_mode():
        want = model32(*fwd_args[1:])
    got, _ = run("forward", fwd_args, 0, AOTI_RUNS, runner=False)
    peak = float(want.abs().max())
    bound = FORWARD_TOL * (want.abs() + peak)
    err, wrong = [float(((y - want).abs() / bound).max()) for y in (got, want16.float())]
    print(f"aoti: forward package (float32) by aoti_load.py vs the live model: "
          f"max_abs_err={float((got - want).abs().max()):.3e} on a peak of {peak:.3f}, "
          f"{err:.3f} of the bound {FORWARD_TOL} of each element plus of the peak (the bfloat16 "
          f"forward: {wrong:.3f} of it), relative L2 {_rel_l2([got], [want]):.3e}", flush=True)
    check(got.shape == want.shape and err <= 1.0 < wrong,
          "aoti: the forward package disagrees with the live model")

    # warm runs: package (above) against the torch.export program and the live path
    programs = {"griffinlim": pe.load_artifact(ref["paths"]["griffinlim"]).module(),
                **{k: pe.load_artifact(p).module() for k, p in compiling["paths32"].items()}}
    s_args = (*s_args[:-1], pe.iterations(N_ITER))
    live = {"forward": lambda: model32(*fwd_args[1:]),
            "griffinlim": lambda: tgl.griffinlim(mag, init_phase=phase, n_iter=N_ITER,
                                                 device=cuda),
            "serving": lambda: synth32.synthesize_waveform(n_iter=N_ITER)}
    args = {"forward": fwd_args, "griffinlim": gl_args, "serving": s_args}
    with torch.inference_mode():
        for name in ("forward", "griffinlim", "serving"):
            glue.reset_launches()
            prog_s = _warm_s(torch, lambda: programs[name](*args[name]))
            live_s = _warm_s(torch, live[name])
            n += counted(glue, 0 if name == "forward" else 4 * N_ITER, f"aoti: {name} timing")
            print(f"aoti: {name} warm run{'' if name == 'griffinlim' else ' (float32)'}: "
                  f"package {ref[name + '_package_s']:.4f} s, torch.export program "
                  f"{prog_s:.4f} s, live path {live_s:.4f} s", flush=True)
        # device kernels per Griffin-Lim iteration: the package in this process, the live path
        glue.reset_launches()
        package = torch._inductor.aoti_load_package(pkgs["griffinlim"])
        package(*gl_args)
        per_pkg = _kernels_per_run(torch, lambda: package(*gl_args)) / N_ITER
        per_live = _kernels_per_run(torch, live["griffinlim"]) / N_ITER
        n += counted(glue, 3 * N_ITER, "aoti: profiled runs")
    print(f"aoti: device kernels per Griffin-Lim iteration (860 frames, profiler, the istft "
          f"included): package {per_pkg:.2f}, live path {per_live:.2f}")
    del programs, model32, synth32, package
    return n


# ---- phase 18: support code -----------------------------------------------------

SPAN_TOL = 0.05
TRAIN_PHASES = ("train.forward", "train.loss", "train.backward", "train.optimizer")
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")  # cuDNN's layout transposes
PNET_CONV_CALLS = 99  # convolution calls of one PerformanceNet forward


def support_phase(torch, dk, glue, binf, state, cfg, tmp):
    """Phase 18: ``device_trace`` of a warm request names both glue kernels
    and its ``profiling.span``; six full-width train steps (batch 16) under
    ``device_trace``: each records ``train.step`` and its four phases with
    one step id, its device time within 5 % of CUDA events around the
    call, and the trace names the spans; no kernel of cuDNN's layout
    transposes runs in them, each step counts its 99 convolution calls
    channel-last, and K4's launch counter reads as many launches as the
    trace holds K4 kernels, the same number each step; the step under
    ``nan_debugging`` (no false positive, 10 + 10 dropout launches seen by
    the mode as ``mmst_torch::dropout_apply``, its slowdown) and a NaN in a
    batch's conditioning raising ``FloatingPointError``; the phase-4 weights
    written as a reference ``.tar``, read back bit-equal and served equal to
    the same weights from memory with ``compat_mbr_noop=True``. Returns
    (dropout launches, glue launches per kernel)."""

    from ml_music_style_transfer_tpu_torch.compat.weights import (load_reference_checkpoint,
                                                                 save_reference_checkpoint)
    from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
    from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
    from ml_music_style_transfer_tpu_torch.infer import synthesize as synth_mod
    from ml_music_style_transfer_tpu_torch.ops.kernels import relayout as rl
    from ml_music_style_transfer_tpu_torch.scripts.bench_train import host_arrays
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer, device_prefetch
    from ml_music_style_transfer_tpu_torch.utils import profiling

    cuda = torch.device("cuda")
    gl = 0
    midi, wav = binf.make_clip(tmp, "trace", 10.0, 72)
    synth = synth_mod.AudioSynthesizer(tmp, midi, wav, model_cfg=cfg, params=state, device=cuda)
    glue.reset_launches()
    synth.synthesize_waveform(n_iter=N_ITER)
    trace_dir = os.path.join(tmp, "trace")
    with profiling.device_trace(trace_dir):
        with profiling.span("mmst.request"):
            synth.synthesize_waveform(n_iter=N_ITER)
    gl += counted(glue, 2 * N_ITER, "traced request (a warm-up, then the traced one)")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in x for x in kernels) for k in ("gl_ola_nola_kernel", "gl_frame_window_kernel")}
    found["mmst.request"] = sum(e.get("name") == "mmst.request" for e in events)
    print(f"support: device_trace of a warm 10 s request: {len(events)} events, "
          f"{os.path.getsize(os.path.join(trace_dir, 'trace.json'))} bytes, {len(kernels)} kernel "
          f"events; events named {found}")
    if not all(found.values()):
        cats = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        print(f"support: trace categories {cats}; kernel names {sorted(set(kernels))[:12]}")
    check(all(found[k] >= N_ITER for k in ("gl_ola_nola_kernel", "gl_frame_window_kernel"))
          and found["mmst.request"] >= 1, "support: the trace lacks the glue kernels or the span")
    del synth

    tr = Trainer(ModelConfig(), TrainConfig(batch_size=16, seed=0), device="cuda")
    tr.init_state(0)
    ds = ChunkDataset.from_arrays(host_arrays(16, seed=18), seed=0)
    batch = next(device_prefetch(ds.epoch_batches(16), cuda))

    def steps(n):
        """n steps, each timed by CUDA events around the call and by the
        host clock from an idle card until its work has run."""
        ev_ms, host_s = [], []
        dk.reset_launches()
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            a.record()
            tr.train_step(batch, tr.next_dropout_seed())
            b.record()
            torch.cuda.synchronize()
            host_s.append(time.perf_counter() - t)
            ev_ms.append(a.elapsed_time(b))
        got = (dk.LAUNCHES["dropout_apply"], dk.LAUNCHES["dropout_grad"])
        check(got == (10 * n, 10 * n), f"support: dropout launches {got} after {n} steps")
        return ev_ms, host_s

    _, host_s = steps(6)
    plain_s = statistics.median(host_s[1:])
    profiling.clear_spans()
    step_dir = os.path.join(tmp, "step_trace")
    rl.reset_launches()
    with profiling.device_trace(step_dir):
        ev_ms, _ = steps(6)
    k4_launches = rl.LAUNCHES["relayout"]
    recs = profiling.spans()
    step_recs = [r for r in recs if r.name == "train.step"]
    check(len(step_recs) == 6 and all(r.device_s is not None for r in step_recs),
          f"support: {len(step_recs)} train.step spans with device times in 6 traced steps")
    for r in step_recs:
        kids = sorted(c.name for c in recs if c.parent == r.id and c.step == r.step)
        check(kids == sorted(TRAIN_PHASES), f"support: step {r.step}'s phases {kids}")
    gaps = [r.device_s * 1e3 / ms - 1 for r, ms in zip(step_recs[1:], ev_ms[1:])]
    phase_ms = {n: statistics.median(1e3 * c.device_s for c in recs if c.name == n)
                for n in TRAIN_PHASES}
    print(f"support: 6 traced steps: train.step device time against CUDA events around the call "
          f"{[round(100 * g, 2) for g in gaps]} % (tolerance {100 * SPAN_TOL:.0f} %); phase "
          f"medians {json.dumps({k: round(v, 3) for k, v in phase_ms.items()})} ms; allocator "
          f"calls {[r.counters.get('allocator_calls') for r in step_recs]}")
    check(all(abs(g) <= SPAN_TOL for g in gaps), "support: span device times disagree with events")
    with open(os.path.join(step_dir, "trace.json")) as f:
        step_events = json.load(f)["traceEvents"]
    named = {e.get("name") for e in step_events}
    check({"train.step", *TRAIN_PHASES} <= named, "support: the trace lacks the train spans")
    # the model runs channel-last: cuDNN transposes nothing, every conv counts
    transposes = sum(e.get("cat") == "kernel" and any(k in e.get("name", "") for k in LAYOUT_KERNELS)
                     for e in step_events)
    convs = [(r.counters.get("conv_calls"), r.counters.get("conv_channel_last_calls"))
             for r in step_recs]
    k4_kernels = sum(e.get("cat") == "kernel" and "relayout_kernel" in e.get("name", "")
                     for e in step_events)
    print(f"support: 6 traced steps: {transposes} layout-transpose kernels "
          f"({' / '.join(LAYOUT_KERNELS)}); (conv calls, channel-last) per step {convs}; "
          f"K4 launches {k4_launches} ({k4_launches / 6:g} a step), {k4_kernels} K4 kernels "
          f"in the trace")
    check(transposes == 0 and all(c == (PNET_CONV_CALLS, PNET_CONV_CALLS) for c in convs),
          "support: a convolution ran channel-first or cuDNN transposed a layout")
    check(k4_launches > 0 and k4_launches % 6 == 0 and k4_kernels == k4_launches,
          "support: K4's launch counter disagrees with the trace or the steps")
    profiling.clear_spans()
    launches = 12 * 20

    debug_s = []
    for i in range(2):
        dk.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profiling.nan_debugging() as mode:
            loss = float(tr.train_step(batch, tr.next_dropout_seed()))
        torch.cuda.synchronize()
        debug_s.append(time.perf_counter() - t)
        seen = mode.seen["mmst_torch.dropout_apply.default"]
        got = (dk.LAUNCHES["dropout_apply"], dk.LAUNCHES["dropout_grad"])
        check(np.isfinite(loss) and got == (10, 10) and seen == 20,
              f"support: nan-debug step {i}: loss {loss}, dropout launches {got}, "
              f"operator calls seen by the mode {seen}")
        launches += 20
    print(f"support: train step under nan_debugging (batch 16, full width, bf16): no NaN, loss "
          f"{loss:.6f}, {sum(mode.seen.values())} operator outputs checked, dropout launches "
          f"10 + 10 seen by the mode as mmst_torch::dropout_apply; {[round(x, 3) for x in debug_s]}"
          f" s against {plain_s:.4f} s without the mode ({debug_s[1] / plain_s:.1f}x)")
    bad = dict(batch)
    bad["cond"] = batch["cond"].clone()
    bad["cond"][3, 100, 7] = float("nan")
    try:
        with profiling.nan_debugging():
            tr.train_step(bad, tr.next_dropout_seed())
        fail("support: a NaN in the conditioning did not raise under nan_debugging")
    except FloatingPointError as e:
        print(f"support: NaN injected into batch item 3's conditioning: FloatingPointError: {e}")
        check("aten." in str(e), "support: the NaN error names no operator")
    del tr, batch, bad, ds
    gc.collect()
    torch.cuda.empty_cache()

    path = os.path.join(tmp, "checkpoint-0.tar")
    torch.cuda.synchronize()
    t = time.perf_counter()
    save_reference_checkpoint(path, state, epoch=0)
    write_s = time.perf_counter() - t
    size = os.path.getsize(path)
    t = time.perf_counter()
    back = load_reference_checkpoint(path)
    read_s = time.perf_counter() - t
    check(sorted(back) == sorted(state) and all(torch.equal(back[k], state[k].cpu()) for k in back),
          "support: the .tar read back differs from the weights written")
    print(f"support: reference .tar of the phase-4 weights {size} bytes ({size / 1e9:.3f} GB): "
          f"written in {write_s:.3f} s ({size / 1e9 / write_s:.3f} GB/s), read in {read_s:.3f} s "
          f"({size / 1e9 / read_s:.3f} GB/s), bit-equal")
    del back
    synth_mod.clear_caches()
    noop = dataclasses.replace(cfg, compat_mbr_noop=True)
    waves = {}
    for what, kw in (("tar", dict(model_cfg=cfg, checkpoint_path=path)),
                     ("memory", dict(model_cfg=noop, params={
                         k: v for k, v in state.items() if not k.startswith("MBRBlock")}))):
        glue.reset_launches()
        waves[what] = synth_mod.AudioSynthesizer(tmp, midi, wav, device=cuda,
                                                 **kw).synthesize_waveform(n_iter=N_ITER)
        gl += counted(glue, N_ITER, f"served from {what}")
    os.remove(path)
    synth_mod.clear_caches()
    check(np.array_equal(waves["tar"], waves["memory"]),
          "support: the .tar serves another waveform than the same weights from memory")
    print("support: the .tar served (compat_mbr_noop=True) a waveform equal to the same weights "
          "served from memory")
    return launches, gl


# ---- phase 19: daemon soak --------------------------------------------------------

SOAK_REQUESTS = 40


def soak_phase(torch, glue, state, cfg, tmp) -> int:
    """Phase 19: ``scripts/soak_daemon.run_soak`` at 40 requests on the
    phase-4 weights (its asserts: isolation, no cache warning, finite
    non-silent WAVs, 300 launches of each glue kernel per Griffin-Lim run,
    the novel-length probe). Returns the glue launches per kernel."""
    from ml_music_style_transfer_tpu_torch.infer import synthesize as synth_mod
    from ml_music_style_transfer_tpu_torch.scripts import soak_daemon

    cuda = torch.device("cuda")
    root = os.path.join(tmp, "soak")
    os.makedirs(root)

    def make_synth(midi, wav):
        return synth_mod.AudioSynthesizer(root, midi, wav, model_cfg=cfg, params=state,
                                          device=cuda)

    glue.reset_launches()
    r = soak_daemon.run_soak(make_synth, root, SOAK_REQUESTS, N_ITER, 2, cuda)
    check(r["glue_launches"] == dict(glue.LAUNCHES), "soak: glue launches miscounted")
    lat = " ".join(f"{k}(n={v['n']}) p50={v['p50']:.4f} p99={v['p99']:.4f}"
                   for k, v in r["latency_s"].items())
    print(f"soak: {r['requests']} requests in {r['wall_s']:.2f} s, {r['requests_per_s']:.3f} "
          f"requests/s, ok {r['ok']}/{r['expected_ok']}, {r['bad_requests']} malformed isolated, "
          f"cache warnings {r['cache_warnings']}, {r['wavs_checked']} WAVs checked, peak "
          f"{r['peak_memory_GB']:.3f} GB; latency s {lat}")
    print(f"soak: novel-length probe {r['novel_probe']}; {r['griffinlim_runs']} Griffin-Lim runs, "
          f"glue launches {r['glue_launches']}")
    return r["glue_launches"]["gl_ola_nola"]


# ---- phase 20: the multi-device layer on a 1-rank NCCL group -----------------

MESH_CLIP_SECONDS = 30.0
TS_FWD_TOL_F32 = 1e-3   # max |sharded - whole| / peak, float32 (JAX: 2e-3 + 1e-3 rel at 1/16)
# bfloat16: mean |sharded - whole| at most the bf16 forward's own mean
# distance from the float32 forward. Both paths round every layer to 8
# bits; two independent roundings of that size would lie about 1.4 times it
# apart (0.36 of it at width 1/16 on the CPU, 0.56 at full width on the H100)
TS_FWD_TOL_BF16 = 1.0
# float32 gradients of this model move by percents where the rounding of
# a forward carries an element across a LeakyReLU, MaxPool or L1 kink
# (tests/torch_port_kinks.py; 1.8e-2 between the two paths at full width),
# so whether both paths compute the same gradient is checked in float64:
# relative L2 of all gradients
TS_GRAD_TOL_F64 = 1e-9
TS_STEP_TOL = 1e-3      # relative difference of the loss after one Adam step, float32
MESH_GL_TOL = 1e-3      # glue vs plain Griffin-Lim on a rank's slice: max |diff| / peak


def _part(name: str, t0: float, torch) -> None:
    torch.cuda.synchronize()
    print(f"multi-device: {name}: {time.perf_counter() - t0:.2f} s, max_memory_allocated_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}", flush=True)
    torch.cuda.reset_peak_memory_stats()


def _rel_l2(got: list, want: list) -> float:
    """Relative L2 distance of two lists of tensors, taken as one vector."""
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    return (num / sum(float((b ** 2).sum()) for b in want)) ** 0.5


def multidevice_phase(torch, dk, glue, binf, state, cfg, tmp):
    """The multi-device layer on a process group of this one card (NCCL):
    the (1, 1) mesh Trainer with ZeRO-1 against the plain Trainer, and
    ``.pt`` resumes on one device and on the mesh; the
    time-sharded forward of a 30 s clip against ``whole_clip_forward``
    (float32 and bfloat16) and its train step against the unsharded one;
    sharded Griffin-Lim against ``griffinlim`` from one phase field; the
    serving options (``shard_gl``, bulk Griffin-Lim over the data ranks);
    between them, the dropout and glue kernels at the shapes a mesh of two
    ranks gives them, against their plain versions. Returns (dropout
    launches, glue launches, the dropout masks' max |kernel - plain|)."""

    import torch.distributed as dist

    from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
    from ml_music_style_transfer_tpu_torch.infer import bulk
    from ml_music_style_transfer_tpu_torch.infer import synthesize as S
    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
    from ml_music_style_transfer_tpu_torch.parallel import gl_shard
    from ml_music_style_transfer_tpu_torch.parallel import mesh as pmesh
    from ml_music_style_transfer_tpu_torch.parallel import time_shard as tsh
    from ml_music_style_transfer_tpu_torch.scripts.bench_train import host_arrays
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer, stage_batch

    cuda = torch.device("cuda")
    pmesh.distributed_init("cuda", init_method=f"tcp://localhost:{pmesh.free_port()}",
                           world_size=1, rank=0)
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not nccl")
    mesh = pmesh.make_mesh(1, 1, device="cuda")
    tmesh = pmesh.make_axis_mesh(1, "time", device="cuda")
    print(f"multi-device: NCCL group of {dist.get_world_size()} rank, meshes "
          f"{pmesh.mesh_shape(mesh)} and {pmesh.mesh_shape(tmesh)}")
    torch.cuda.reset_peak_memory_stats()

    # 1. the mesh Trainer (DP all-reduce + ZeRO-1) against the plain one
    t0 = time.perf_counter()
    raw = host_arrays(16, seed=5)
    cond_key, target_key = sorted(k for k in raw if k.startswith("spec_"))[:2]
    host = {"midi": raw["pianoroll"], "onoff": raw["onoff"],
            "cond": np.ascontiguousarray(raw[cond_key].transpose(0, 2, 1)),
            "target": np.ascontiguousarray(raw[target_key].transpose(0, 2, 1)),
            "weight": np.ones((16,), np.float32)}
    plain = Trainer(ModelConfig(), TrainConfig(batch_size=16), device="cuda")
    plain.init_state(0)
    meshed = Trainer(ModelConfig(), TrainConfig(batch_size=16, zero_opt=True), device="cuda",
                     mesh=mesh)
    meshed.init_state(0)
    check(type(meshed.optimizer).__name__ == "ZeroOptimizer", "the mesh Trainer has no ZeRO")
    batch = stage_batch(host, cuda)
    seed = plain.next_dropout_seed()
    dk.reset_launches()
    loss_p = float(plain.train_step(batch, seed))
    want = (dk.LAUNCHES["dropout_apply"], dk.LAUNCHES["dropout_grad"])
    dk.reset_launches()
    loss_m = float(meshed.train_step(meshed.shard_batch(batch), seed))
    launches = (dk.LAUNCHES["dropout_apply"], dk.LAUNCHES["dropout_grad"])
    diff = max(float((a - b).abs().max()) for a, b in
               zip(plain.model.parameters(), meshed.model.parameters()))
    print(f"multi-device: mesh (1, 1) ZeRO-1 step loss {loss_m:.6f} vs plain {loss_p:.6f}; "
          f"max |weights - plain weights| after the step {diff:.3e}; dropout launches "
          f"{launches} (plain {want})")
    check(launches == (10, 10) and want == (10, 10), f"dropout launches {launches}, {want}")
    n_dropout = sum(launches)
    check(loss_m == loss_p and diff == 0.0, "the mesh ZeRO-1 step differs from the plain step")
    del plain, meshed, batch
    gc.collect()
    torch.cuda.empty_cache()
    _part("mesh Trainer step (batch 16, T 860, bf16, full width)", t0, torch)

    # checkpoints: a .pt written after two steps resumes bit for bit, on one
    # device and on the mesh with ZeRO-1 (every optimizer option on)
    t0 = time.perf_counter()
    small = {k: v[:4] for k, v in host.items()}
    batch = stage_batch(small, cuda)
    opts = dict(batch_size=4, adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                grad_clip_norm=1.0, warmup_steps=2, ema_decay=0.999, grad_accum=2)
    for zero in (False, True):
        def trainer(seed):
            tr = Trainer(ModelConfig(width_mult=0.25), TrainConfig(zero_opt=zero, **opts),
                         device="cuda", mesh=mesh if zero else None)
            tr.init_state(seed)
            return tr

        a = trainer(0)
        for s in range(2):
            a.train_step(a.shard_batch(batch), 100 + s)
        path = ckpt.save_checkpoint(tmp, 1, a.state_dict(1))
        b = trainer(1)
        b.load_state(ckpt.restore_checkpoint(path, device=cuda))
        os.remove(path)
        la = [float(a.train_step(a.shard_batch(batch), 200 + s)) for s in range(2)]
        lb = [float(b.train_step(b.shard_batch(batch), 200 + s)) for s in range(2)]
        diff = max(float((x.detach() - y.detach()).abs().max()) for x, y in
                   zip(a.model.parameters(), b.model.parameters()))
        print(f"multi-device: .pt resume ({'(1, 1) mesh, ZeRO-1' if zero else 'one device'}, "
              f"width 1/4, every optimizer option): losses after it {la} vs {lb}, max "
              f"|weights - resumed weights| {diff:.3e}")
        check(la == lb and diff == 0.0, "a resumed Trainer differs from the one it saved")
        del a, b
    del batch
    _part("checkpoint resume", t0, torch)

    # 2. the time-sharded forward of a 30 s clip, and its train step
    t0 = time.perf_counter()
    midi, wav = binf.make_clip(tmp, "mesh30", MESH_CLIP_SECONDS, 77, timbre_seconds=30.0)
    synth = S.AudioSynthesizer(tmp, midi, wav, model_cfg=cfg, params=state, device="cuda")
    roll, onoff, cond, t_total = synth.process_whole_clip(midi, wav)
    want = synth.predict_spectrogram_whole_clip(roll, onoff, cond, t_total)
    got = synth.predict_spectrogram_whole_clip(roll, onoff, cond, t_total, mesh=tmesh)
    f32 = S.build_model(dataclasses.replace(cfg, compute_dtype="float32"), state, cuda)
    f32.requires_grad_(True)

    def up(a, t):
        return torch.from_numpy(np.ascontiguousarray(a[None, :t], np.float32)).to(cuda)

    xs = [up(a, t_total) for a in (roll, cond, onoff)]
    with torch.no_grad():
        whole = f32(*xs).float()
    t_out = whole.shape[1]
    w32 = whole[0].cpu().numpy()
    err16, bf16_scale = float(np.abs(got - want).mean()), float(np.abs(want - w32).mean())
    print(f"multi-device: time-sharded forward, {t_total} frames (t_out {t_out}), bf16: mean "
          f"|sharded - whole| {err16:.4e}, max/peak {np.abs(got - want).max() / np.abs(want).max():.3e}; "
          f"bf16's own mean distance from float32 {bf16_scale:.4e} (tolerance "
          f"{TS_FWD_TOL_BF16} of it)")
    check(got.shape == want.shape == w32.shape and err16 <= TS_FWD_TOL_BF16 * bf16_scale,
          "the bf16 time-sharded forward disagrees with whole_clip_forward")
    fn, t_pad, _ = tsh.make_time_sharded_forward(f32, tmesh, t_total)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, t_pad - x.shape[1]))

    with torch.no_grad():
        sharded = fn(*[pad(x) for x in xs])[:, :t_out]
    err32 = float((sharded - whole).abs().max() / whole.abs().max())
    print(f"multi-device: time-sharded forward, float32: max_abs_err/peak {err32:.3e} "
          f"(tolerance {TS_FWD_TOL_F32}), padded to {t_pad} frames")
    check(err32 <= TS_FWD_TOL_F32, "the float32 time-sharded forward disagrees")
    _part("time-sharded forward (30 s clip, full width)", t0, torch)

    t0 = time.perf_counter()
    target = torch.rand((1, t_out, 1025), generator=torch.Generator().manual_seed(9)).to(cuda) * 8
    w0 = [p.detach().clone() for p in f32.parameters()]
    opt = torch.optim.Adam(f32.parameters(), lr=1e-4, fused=True)
    loss_p = torch.mean(torch.abs(f32(*xs).float() - target))
    loss_p.backward()
    g_p = [p.grad.detach().clone() for p in f32.parameters()]
    opt.step()
    with torch.no_grad():
        post_p = float(torch.mean(torch.abs(f32(*xs).float() - target)))
    del opt
    with torch.no_grad():
        for p, w in zip(f32.parameters(), w0):
            p.copy_(w)
            p.grad = None
    tst = tsh.make_time_sharded_train_step(f32, tmesh, t_total, learning_rate=1e-4)
    args = [pad(x) for x in xs] + [pad(target)]
    loss_s, grads = tst.value_and_grad(*args)
    rel = _rel_l2(list(grads.values()), g_p)
    tst.optimizer.step()
    with torch.no_grad():
        post_s = float(torch.mean(torch.abs(fn(*args[:3])[:, :t_out] - target)))
    step_rel = abs(post_s - post_p) / abs(post_p)
    print(f"multi-device: time-sharded train step, float32: loss {float(loss_s):.6f} vs "
          f"unsharded {float(loss_p):.6f}; gradients' relative L2 {rel:.3e}; loss after one "
          f"Adam step {post_s:.6f} vs {post_p:.6f} (relative {step_rel:.3e}, tolerance "
          f"{TS_STEP_TOL})")
    check(abs(float(loss_s) - float(loss_p)) <= 1e-5 * abs(float(loss_p)),
          "the time-sharded loss disagrees")
    check(step_rel <= TS_STEP_TOL, "the time-sharded train step disagrees with the unsharded one")
    del f32, tst, w0, g_p, grads, whole, sharded
    gc.collect()
    torch.cuda.empty_cache()
    _part("time-sharded train step (30 s clip, full width, float32)", t0, torch)

    t0 = time.perf_counter()
    f64 = S.build_model(dataclasses.replace(cfg, compute_dtype="float64"), state, cuda).double()
    f64.requires_grad_(True)
    xs, target = [x.double() for x in xs], target.double()
    loss_p = torch.mean(torch.abs(f64(*xs) - target))
    loss_p.backward()
    g_p = [p.grad.detach().clone() for p in f64.parameters()]
    f64.zero_grad(set_to_none=True)
    tst = tsh.make_time_sharded_train_step(f64, tmesh, t_total)
    loss_s, grads = tst.value_and_grad(*[pad(x) for x in xs], pad(target))
    rel = _rel_l2(list(grads.values()), g_p)
    print(f"multi-device: time-sharded gradients, float64: loss {float(loss_s):.12f} vs "
          f"{float(loss_p):.12f}; gradients' relative L2 {rel:.3e} (tolerance {TS_GRAD_TOL_F64})")
    check(rel <= TS_GRAD_TOL_F64, "the time-sharded gradients differ from the unsharded ones")
    del f64, tst, g_p, grads, xs, target
    gc.collect()
    torch.cuda.empty_cache()
    _part("time-sharded gradients (30 s clip, full width, float64)", t0, torch)

    # 3. sharded Griffin-Lim on the clip's spectrogram, from one phase field
    t0 = time.perf_counter()
    spec, t_out = synth._predict_whole_clip_device()
    glue.reset_launches()
    with torch.inference_mode():
        wav_s = gl_shard.sharded_griffinlim_from_log_power(spec, tmesh, n_iter=N_ITER, seed=0)
    n_gl = counted(glue, N_ITER, "sharded Griffin-Lim")
    with torch.inference_mode():
        wav_p = tgl.griffinlim_from_log_power(spec.transpose(0, 1).contiguous(),
                                              generator=torch.Generator().manual_seed(0),
                                              n_iter=N_ITER, device=cuda)
    equal = bool(torch.equal(wav_s[:wav_p.shape[0]], wav_p))
    print(f"multi-device: sharded Griffin-Lim ({spec.shape[0]} frames, {N_ITER} iterations, 1 rank) "
          f"bit-equal to griffinlim from the same phase field: {equal}; glue launches "
          f"{N_ITER} of each")
    check(equal and bool((wav_s[wav_p.shape[0]:] == 0).all()),
          "sharded Griffin-Lim differs from griffinlim")
    _part("sharded Griffin-Lim", t0, torch)

    # the kernels at the shapes of a mesh of two ranks, against their plain
    # versions (these launches are comparisons, not the paths')
    t0 = time.perf_counter()
    mask_err = mesh_dropout_check(torch, dk)
    mesh_glue_check(torch, glue, spec[:t_out], t_total, cfg, synth.hp)
    _part("kernels at two ranks' shapes", t0, torch)

    # 4. the serving options
    t0 = time.perf_counter()
    glue.reset_launches()
    y_on = synth.synthesize_whole_clip(n_iter=N_ITER, mesh=tmesh, shard_gl=True)
    y_off = synth.synthesize_whole_clip(n_iter=N_ITER, mesh=tmesh, shard_gl=False)
    n_gl += counted(glue, 2 * N_ITER, "synthesize_whole_clip(mesh, shard_gl=True/False)")
    check(np.array_equal(y_on, y_off) and y_on.shape == (t_out * 256,),
          "synthesize_whole_clip(shard_gl=True) differs from shard_gl=False")
    specs = torch.stack([spec.transpose(0, 1), 0.9 * spec.transpose(0, 1)]).contiguous()
    glue.reset_launches()
    with torch.inference_mode():
        wavs = bulk.bulk_griffinlim(specs, [0, 1], mesh=mesh, n_iter=N_ITER)
    n_gl += counted(glue, 2 * N_ITER, "bulk Griffin-Lim over the data ranks")
    with torch.inference_mode():
        per_clip = [tgl.griffinlim_from_log_power(s, generator=torch.Generator().manual_seed(i),
                                                  n_iter=N_ITER, device=cuda)
                    for i, s in enumerate(specs)]
    check(all(torch.equal(w, p) for w, p in zip(wavs, per_clip)),
          "bulk Griffin-Lim over the mesh differs from per-clip Griffin-Lim")
    print(f"multi-device: synthesize_whole_clip(mesh, shard_gl=True) == shard_gl=False "
          f"({y_on.shape[0]} samples); bulk_griffinlim over the (1, 1) mesh == per clip")
    _part("serving options", t0, torch)
    dist.destroy_process_group()
    return n_dropout, n_gl, mask_err


def mesh_dropout_check(torch, dk, data: int = 2, model: int = 2) -> float:
    """DenseConcat's dropout masks on a (data, model) mesh at full width
    and batch 16: each data rank's batch share, fc1's hidden output sliced
    over the model axis. The first mask folds the data and the model rank
    into the seed, the second only the data rank (``fold_seed``). Kernel
    against ``dropout_mask_reference`` bit for bit; data ranks draw other
    masks, model ranks other first masks and the same second; rank 0 one
    device's. Returns the max |kernel - plain|."""
    seed, rate, dt = DROPOUT_SEED, DROPOUT_RATE, torch.bfloat16
    shapes = dense_concat_shapes(batch=16 // data)
    err = 0.0
    for j in range(0, len(shapes), 2):
        (b, hidden, t), out = shapes[j], shapes[j + 1]
        first, second = {}, {}
        for d in range(data):
            sd = dk.fold_seed(seed, d)
            for m in range(model):
                s1 = dk.fold_seed(sd, m)
                for masks, s, call, shape in ((first, s1, j, (b, hidden // model, t)),
                                              (second, sd, j + 1, out)):
                    masks[d, m] = dk.dropout_mask(s, call, shape, rate, dt)
                    ref = dk.dropout_mask_reference(s, call, shape, rate, dt, "cuda")
                    err = max(err, float((masks[d, m].float() - ref.float()).abs().max()))
                    check(torch.equal(masks[d, m], ref),
                          f"dropout kernel differs from its plain version at {shape}, "
                          f"mesh rank ({d}, {m})")
        check(torch.equal(first[0, 0], dk.dropout_mask(seed, j, (b, hidden // model, t), rate,
                                                       dt)),
              "rank (0, 0) does not draw one device's mask")
        for m in range(model):
            check(not torch.equal(first[0, m], first[1, m])
                  and not torch.equal(second[0, m], second[1, m]),
                  "two data ranks drew the same dropout mask")
        for d in range(data):
            check(torch.equal(second[d, 0], second[d, 1]) and not torch.equal(first[d, 0],
                                                                              first[d, 1]),
                  "fc2's mask differs across model ranks or fc1's does not")
    print(f"multi-device: dropout kernel under the ({data}, {model}) mesh's seed folding at "
          f"{len(shapes) // 2} DenseConcats x {data * model} ranks x 2 masks: bit-equal to "
          f"dropout_mask_reference (max_abs_err {err:.3e})")
    return err


def mesh_glue_check(torch, glue, spec, t_total: int, cfg, hp, n: int = 2, halo: int = 32,
                    rounds: int = 10) -> None:
    """One Schwarz block of sharded Griffin-Lim (``N_ITER // rounds``
    iterations) on each of n ranks' extended slices (t_loc + 2 halo
    frames) of the (t_out, bins) spectrogram ``spec``, padded as the
    time-sharded forward pads the clip: through the glue kernels (a launch
    of each per iteration) and through the plain istft/stft path, within
    ``MESH_GL_TOL`` of the plain waveform's peak."""
    import torch.nn.functional as F

    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
    from ml_music_style_transfer_tpu_torch.ops import stft as tstft
    from ml_music_style_transfer_tpu_torch.parallel import gl_shard
    from ml_music_style_transfer_tpu_torch.parallel import time_shard as tsh

    t_pad = tsh.padded_length(t_total, n, cfg.depth)
    full = F.pad(spec, (0, 0, 0, t_pad - spec.shape[0]))
    t_loc, bins, k = t_pad // n, spec.shape[1], N_ITER // rounds
    n_fft = 2 * (bins - 1)
    field = gl_shard.phase_field(bins, t_pad, seed=0).cuda()
    for r in range(n):
        mag, angles = gl_shard.rank_inputs(full, field, r, t_loc, halo, hp.clip_log_power_max)
        check(glue.supported(mag.shape[-1], n_fft, hp.ws),
              f"the glue kernels do not take a rank's {mag.shape[-1]} frames")
        wavs = []
        for use_glue in (True, False):
            glue.reset_launches()
            with torch.inference_mode():
                a, _ = tgl.gl_steps(mag, (angles, torch.zeros_like(angles)), k, hp.ws, n_fft,
                                    use_pallas_glue=use_glue)
                wavs.append(tstft.istft(mag * a, hp.ws, n_fft))
            counted(glue, k if use_glue else 0, f"Griffin-Lim on rank {r}'s slice")
        err = float((wavs[0] - wavs[1]).abs().max() / wavs[1].abs().max())
        print(f"multi-device: rank {r} of {n}: {mag.shape[-1]} frames ({t_loc} + 2 x {halo} "
              f"halo), {k} iterations through the glue kernels vs the plain path: max |diff| / "
              f"peak {err:.3e} (tolerance {MESH_GL_TOL}); {k} launches of each")
        check(err <= MESH_GL_TOL, f"the glue kernels disagree on rank {r}'s slice")


# ---- phase 21: sharded asynchronous checkpoints, the WAV decoder, the profiles ---

DECODER_RUN = 10  # daemon requests per timed run of one WAV decoder
DECODER_ROUNDS = 3  # runs of each decoder at each depth, the decoders in turns


def _stored_bytes(path: str, key: str) -> int:
    """Bytes of a ``.dcp``'s storage items under top-level ``key``."""
    from torch.distributed.checkpoint import FileSystemReader

    md = FileSystemReader(path).read_metadata()
    return sum(info.length for idx, info in md.storage_data.items()
               if md.planner_data[idx.fqn][0] == key)


class _CountingStream:
    """A binary file whose reads add the bytes they return to ``total[0]``."""

    def __init__(self, f, total: list):
        self._f, self._total = f, total

    def __getattr__(self, name):
        return getattr(self._f, name)

    def _count(self, out):
        self._total[0] += len(out)
        return out

    def read(self, *a):
        return self._count(self._f.read(*a))

    def read1(self, *a):
        return self._count(self._f.read1(*a))

    def readline(self, *a):
        return self._count(self._f.readline(*a))

    def readinto(self, b):
        n = self._f.readinto(b)
        self._total[0] += n or 0
        return n


@contextlib.contextmanager
def dcp_bytes_read():
    """Yields ``[n]``: the bytes DCP's file reads return while the block runs
    (every stream ``FileSystem.create_stream`` opens for reading is
    counted: the metadata and each item read)."""
    from torch.distributed.checkpoint import filesystem

    create = filesystem.FileSystem.create_stream
    total = [0]

    @contextlib.contextmanager
    def counted(self, path, mode):
        with create(self, path, mode) as stream:
            yield _CountingStream(stream, total) if "r" in mode else stream

    filesystem.FileSystem.create_stream = counted
    try:
        yield total
    finally:
        filesystem.FileSystem.create_stream = create


def _same_tree(torch, got, want, path="") -> list:
    """Paths where ``got`` and ``want`` differ (tensors bit for bit)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path or "<root>"]
        return [p for k in want for p in _same_tree(torch, got[k], want[k], f"{path}.{k}")]
    if isinstance(want, torch.Tensor):
        ok = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
              and torch.equal(got.to(want.device), want))
        return [] if ok else [path]
    return [] if got == want else [path]


def checkpoint_phase(torch, dk, glue, binf, tmp):
    """Sharded asynchronous checkpoints at full width (731,945,857 params,
    fused float32 Adam, batch 16 of seeded chunks, bf16): a synchronous
    ``.pt`` save's seconds; ``save_checkpoint_sharded``'s seconds to return
    and to commit, the first save (page-locked staging buffers allocated)
    and a second (buffers reused); the median step while the first write
    runs against the same steps with no write (10 + 10 dropout launches
    each); the restore of the first save into a fresh Trainer, bit-equal to
    the state at the save call (every tensor); the params-only restore's
    seconds and bytes read against the ``.pt``'s (mapped, and read whole as
    before); a warm 30 s request served from the ``.dcp`` equal to serving
    the weights at the save from memory (300 launches of each glue kernel);
    a (1, 1) mesh Trainer with ZeRO-1 on a NCCL group of one restores the
    one-device ``.dcp`` into its placement, saves its own and a fresh mesh
    Trainer resumes it, the next step bit-identical. Then the native WAV
    decoder against scipy (30 s stereo int16 at 44.1 kHz, and at 48 kHz
    resampled; max error and ms), the daemon's requests/s with each decoder
    (10 s songs, each with one of those two files as its timbre; runs of 10
    requests, serial and pipelined, the decoders in turns, 60 requests per
    decoder, after two untimed requests);
    and the two profile scripts at reduced counts. Returns (dropout
    launches, glue launches, the params-only restore's seconds and bytes
    read)."""
    import functools

    import torch.distributed as dist
    from scipy.io import wavfile

    from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
    from ml_music_style_transfer_tpu_torch.data import audio_io
    from ml_music_style_transfer_tpu_torch.infer import synthesize as S
    from ml_music_style_transfer_tpu_torch.parallel import mesh as pmesh
    from ml_music_style_transfer_tpu_torch.scripts import profile_gl, profile_step
    from ml_music_style_transfer_tpu_torch.scripts.bench_train import host_arrays
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer, stage_batch

    cuda = torch.device("cuda")
    raw = host_arrays(16, seed=21)
    cond_key, target_key = sorted(k for k in raw if k.startswith("spec_"))[:2]
    batch = stage_batch({"midi": raw["pianoroll"], "onoff": raw["onoff"],
                         "cond": np.ascontiguousarray(raw[cond_key].transpose(0, 2, 1)),
                         "target": np.ascontiguousarray(raw[target_key].transpose(0, 2, 1)),
                         "weight": np.ones((16,), np.float32)}, cuda)
    del raw
    tr = Trainer(ModelConfig(), TrainConfig(batch_size=16), device="cuda")
    tr.init_state(0)
    n_params = sum(p.numel() for p in tr.model.parameters())
    check(n_params == FULL_WIDTH_PARAMS, f"checkpoints: {n_params} params")
    dk.reset_launches()
    n_steps = 0

    def step_s(trainer) -> float:
        """Seconds of one train step, synchronised on both sides."""
        nonlocal n_steps
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_step(batch, trainer.next_dropout_seed())
        torch.cuda.synchronize()
        n_steps += 1
        return time.perf_counter() - t

    for _ in range(2):  # warm
        step_s(tr)
    state_gb = 3 * 4 * n_params / 1e9

    # a synchronous .pt, and the steps with no write going on
    t = time.perf_counter()
    pt_path = ckpt.save_checkpoint(tmp, 1, tr.state_dict(1))
    pt_s = time.perf_counter() - t
    quiet = [step_s(tr) for _ in range(6)]

    # the sharded save: staged, returned, written while the steps run
    want = ckpt.tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor) else v,
                          tr.state_dict(1))
    pool: dict = {}  # the staging buffers, kept from save to save as fit keeps them
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint_sharded(tmp, 1, tr.sharded_state_dict(1), buffers=pool)
    ret_s = time.perf_counter() - t0
    during, flushing = [], []  # each step's seconds; whether the write ran at its start
    while len(during) < 6 or (flushing[-1] and len(during) < 60):
        flushing.append(not os.path.exists(path))
        during.append(step_s(tr))
    ckpt.wait_for_async_saves()
    commit_s = time.perf_counter() - t0
    n_during = sum(flushing)
    overlapped = [d for d, f in zip(during, flushing) if f]
    check(n_during >= 5, f"checkpoints: only {n_during} steps ran while the write went on")
    check(dk.LAUNCHES["dropout_apply"] == dk.LAUNCHES["dropout_grad"] == 10 * n_steps,
          f"checkpoints: dropout launches {dict(dk.LAUNCHES)} after {n_steps} steps")
    on_disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    print(f"checkpoints: state {state_gb:.2f} GB (params + Adam moments, float32); .pt "
          f"synchronous save {pt_s:.2f} s ({os.path.getsize(pt_path) / 1e9:.2f} GB); "
          f".dcp save_checkpoint_sharded returned after {ret_s:.3f} s (first save: page-locked "
          f"staging allocated), committed after {commit_s:.2f} s ({on_disk / 1e9:.2f} GB)")
    print(f"checkpoints: step s with no write {[round(x, 4) for x in quiet]} (median "
          f"{statistics.median(quiet):.4f}); during the write {[round(x, 4) for x in during]} "
          f"(median of the {n_during} that ran while it went on "
          f"{statistics.median(overlapped):.4f}); dropout launches 10 + 10 per step")

    # the restore into a fresh Trainer: the state at the save call
    t = time.perf_counter()
    tr2 = Trainer(ModelConfig(), TrainConfig(batch_size=16), device="cuda")
    tr2.init_state(1)
    epoch = tr2.load_sharded_state(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    diff = _same_tree(torch, tr2.state_dict(epoch), want)
    check(epoch == 1 and not diff, f"checkpoints: the restore differs at {diff[:5]}")
    n_tensors = sum(1 for _ in _leaves(want))
    print(f"checkpoints: restore into a fresh Trainer (init + read + load) {restore_s:.2f} s: "
          f"bit-equal to the state at the save call ({n_tensors} leaves), though "
          f"{n_during} steps changed the weights and moments in place during the write")
    del tr2

    # serving start-up: the params alone, against the .pt
    with dcp_bytes_read() as counted_bytes:
        t = time.perf_counter()
        params = ckpt.restore_checkpoint(path, keys=("params",))["params"]
        dcp_s = time.perf_counter() - t
    dcp_bytes = counted_bytes[0]
    check(not _same_tree(torch, params, want["params"]), "checkpoints: params-only restore")
    t = time.perf_counter()
    mapped = ckpt.restore_checkpoint(pt_path, keys=("params",))["params"]
    S.build_model(ModelConfig(), mapped, cuda)
    torch.cuda.synchronize()
    pt_mapped_s = time.perf_counter() - t
    t = time.perf_counter()
    S.build_model(ModelConfig(), params, cuda)
    torch.cuda.synchronize()
    dcp_upload_s = time.perf_counter() - t
    t = time.perf_counter()
    whole = torch.load(pt_path, map_location="cpu", weights_only=True)
    pt_whole_s, pt_whole_bytes = time.perf_counter() - t, os.path.getsize(pt_path)
    params_gb = 4 * n_params / 1e9
    check(4 * n_params <= dcp_bytes < 1.1 * 4 * n_params,
          f"checkpoints: the params-only read read {dcp_bytes} B")
    print(f"checkpoints: params-only restore of the .dcp {dcp_s:.2f} s, {dcp_bytes / 1e9:.3f} GB "
          f"read from its files, counted at DCP's file streams (params {params_gb:.2f} GB, "
          f"stored as {_stored_bytes(path, 'params') / 1e9:.3f} GB of {on_disk / 1e9:.3f} GB; "
          f"page cache warm), model built on the card from it "
          f"{dcp_upload_s:.2f} s more; the .pt's params through its memory map, model built, "
          f"{pt_mapped_s:.2f} s; the whole .pt read as before {pt_whole_s:.2f} s, "
          f"{pt_whole_bytes / 1e9:.3f} GB read")
    del whole, mapped
    os.remove(pt_path)

    # a warm 30 s request served from the .dcp against the weights at the save
    midi, wav = binf.make_clip(tmp, "ckpt", 30.0, 21)
    S.clear_caches()
    gl = 0
    from_file = S.AudioSynthesizer(tmp, midi, wav, model_cfg=ModelConfig(),
                                   checkpoint_path=path, device="cuda")
    live = S.AudioSynthesizer(tmp, midi, wav, model_cfg=ModelConfig(), params=want["params"],
                              device="cuda")
    waves = {}
    for what, synth in (("dcp, first", from_file), ("dcp, warm", from_file), ("memory", live)):
        glue.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        waves[what] = synth.synthesize_waveform(n_iter=N_ITER)
        dt = time.perf_counter() - t
        gl += counted(glue, N_ITER, f"checkpoints: request ({what})")
        print(f"checkpoints: 30 s request, weights from {what}: {dt:.4f} s")
        if what == "dcp, warm":
            print(binf.metric_line("serving_s_per_30s_clip", dt, "s", cuda, midi_s=30.0,
                                   n_iter=N_ITER, request="params from .dcp (warm)"))
    y = waves["dcp, warm"]
    check(y.shape == (midi_frames(midi) * 256,) and bool(np.isfinite(y).all()),
          "checkpoints: waveform shape or values")
    check(np.array_equal(y, waves["memory"]) and np.array_equal(y, waves["dcp, first"]),
          "checkpoints: serving from the .dcp differs from serving the same weights from memory")
    print("checkpoints: served from the .dcp (only 'params' read): waveform equal to the "
          "weights at the save served from memory; 300 launches of each glue kernel per request")
    make_synth = functools.partial(S.AudioSynthesizer, tmp, model_cfg=ModelConfig(),
                                   params=params, device="cuda")
    del from_file, live, waves
    S.clear_caches()

    # ZeRO-1 on a (1, 1) mesh over a NCCL group of one
    t = time.perf_counter()
    pmesh.distributed_init("cuda", init_method=f"tcp://localhost:{pmesh.free_port()}",
                           world_size=1, rank=0)
    mesh = pmesh.make_mesh(1, 1, device="cuda")
    zcfg = TrainConfig(batch_size=16, zero_opt=True)
    tz = Trainer(ModelConfig(), zcfg, device="cuda", mesh=mesh)
    tz.init_state(1)
    tz.load_sharded_state(path)
    diff = _same_tree(torch, tz.state_dict(1), want)
    check(not diff, f"checkpoints: the one-device .dcp restored on the mesh differs at {diff[:5]}")
    del want
    t1 = time.perf_counter()
    zpath = ckpt.save_checkpoint_sharded(os.path.join(tmp, "zero"), 2, tz.sharded_state_dict(2),
                                         buffers=pool)
    zret_s = time.perf_counter() - t1
    loss_a = float(tz.train_step(batch, 7))  # in place, during the write
    ckpt.wait_for_async_saves()
    zcommit_s = time.perf_counter() - t1
    pool.clear()
    after_a = {k: v.clone() for k, v in tz.model.state_dict().items()}
    del tz, tr
    gc.collect()
    tz2 = Trainer(ModelConfig(), zcfg, device="cuda", mesh=mesh)
    tz2.init_state(2)
    check(tz2.load_sharded_state(zpath) == 2, "checkpoints: ZeRO resume epoch")
    loss_b = float(tz2.train_step(batch, 7))
    diff = _same_tree(torch, tz2.model.state_dict(), after_a)
    check(loss_a == loss_b and not diff,
          f"checkpoints: ZeRO step after the .dcp resume differs ({loss_a} vs {loss_b}, {diff[:5]})")
    n_steps += 2
    check(dk.LAUNCHES["dropout_apply"] == dk.LAUNCHES["dropout_grad"] == 10 * n_steps,
          f"checkpoints: dropout launches {dict(dk.LAUNCHES)} after {n_steps} steps")
    print(f"checkpoints: (1, 1) mesh, ZeRO-1, NCCL group of one: the one-device .dcp restored "
          f"into its placement bit-equal; its own .dcp resumed and the next step bit-identical "
          f"(loss {loss_b:.6f}); {time.perf_counter() - t:.2f} s")
    print(f"checkpoints: second save_checkpoint_sharded (the mesh's, staging buffers reused) "
          f"returned after {zret_s:.3f} s, committed after {zcommit_s:.2f} s")
    del tz2, after_a, batch
    dist.destroy_process_group()
    shutil.rmtree(path)
    shutil.rmtree(zpath)
    gc.collect()
    torch.cuda.empty_cache()

    # the native WAV decoder against scipy
    rng = np.random.default_rng(22)
    for rate in (44100, 48000):
        st = (0.3 * rng.standard_normal((30 * rate, 2))).clip(-1, 1)
        wpath = os.path.join(tmp, f"stereo{rate}.wav")
        wavfile.write(wpath, rate, (st * 32767).astype(np.int16))
        ms = {}
        for name, native in (("native", None), ("scipy", False)):
            runs = []
            for _ in range(3):
                t = time.perf_counter()
                y_dec, got_rate = audio_io.read_wav(wpath, sr=44100, native=native)
                runs.append((time.perf_counter() - t) * 1e3)
            ms[name] = (statistics.median(runs), y_dec)
        err = float(np.abs(ms["native"][1] - ms["scipy"][1]).max())
        check(err <= 1e-6 and ms["native"][1].shape == ms["scipy"][1].shape,
              f"wavdec: native vs scipy at {rate} Hz: max error {err}")
        print(f"wavdec: 30 s stereo int16 at {rate} Hz -> 44.1 kHz mono: native "
              f"{ms['native'][0]:.2f} ms, scipy {ms['scipy'][0]:.2f} ms, max |native - scipy| "
              f"{err:.3g}")
    # the daemon with each decoder, on what it reads: 10 s songs, each with a
    # 30 s stereo timbre at 44.1 or 48 kHz (resampled as it is decoded)
    timbres = [os.path.join(tmp, f"stereo{rate}.wav") for rate in (44100, 48000)]
    songs = [binf.make_clip(tmp, f"wd{i}", 10.0, 60 + i)[0] for i in range(4)]
    singles = [{"midi": songs[i % 4], "audio": timbres[i % 2],
                "out": os.path.join(tmp, f"wd{i}.wav"), "n_iter": N_ITER}
               for i in range(DECODER_RUN)]
    real_read = audio_io.read_wav
    runs = {}  # (decoder, depth) -> seconds of each run
    binf.daemon_seconds(make_synth, singles[:2], 0)  # builds the model: no run pays for it
    try:
        for r in range(DECODER_ROUNDS):
            for decoder in (("native", "scipy") if r % 2 == 0 else ("scipy", "native")):
                audio_io.read_wav = (real_read if decoder == "native"
                                     else functools.partial(real_read, native=False))
                for depth in (0, 2):
                    glue.reset_launches()
                    dt, resps = binf.daemon_seconds(make_synth, singles, depth)
                    gl += counted(glue, DECODER_RUN * N_ITER,
                                  f"wavdec daemon ({decoder}, depth {depth})")
                    check(all(x["ok"] for x in resps), f"wavdec daemon: {resps}")
                    runs.setdefault((decoder, depth), []).append(dt)
    finally:
        audio_io.read_wav = real_read
    for decoder in ("native", "scipy"):
        for depth, name in ((0, "serial"), (2, "pipelined")):
            secs = runs[(decoder, depth)]
            print(binf.metric_line(f"daemon_requests_per_s_{name}",
                                   DECODER_RUN * len(secs) / sum(secs), "requests/s", cuda,
                                   requests=DECODER_RUN * len(secs), midi_s=10.0,
                                   timbre="30 s stereo int16, 44.1 and 48 kHz in turns",
                                   wav_decoder=decoder,
                                   runs=[round(DECODER_RUN / x, 3) for x in secs]))
    S.clear_caches()
    del make_synth, params
    gc.collect()
    torch.cuda.empty_cache()

    # the profile scripts at reduced counts (their launches are not the main path's)
    profile_step.main(["--n-iter", "3", "--warmup", "1"])
    gc.collect()
    torch.cuda.empty_cache()
    profile_gl.main(["--n-iter", "50", "--warmup", "5"])
    dk.reset_launches()
    glue.reset_launches()
    return 20 * n_steps, gl, {"s": dcp_s, "bytes": dcp_bytes}


# ---- phase 22: orbax checkpoints, read and written without orbax ---------------

ORBAX_FIXTURE = os.path.join("tests", "data", "orbax_jax", "checkpoint-1.orbax")
ORBAX_EXPECTED = os.path.join("tests", "data", "orbax_jax_expected.npz")


def _flat_leaves(torch, tree, path=()) -> dict:
    """{key: array} of a JAX-layout tree as the committed expected ``.npz``
    holds it (``tests/test_torch_port_orbax.py``'s ``flat``)."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(torch, v, path + (k,)))
        return out
    key = "/".join(path)
    if isinstance(tree, dict):
        return {f"{key}#empty": np.zeros(0)}
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return {f"{key}#bfloat16": tree.view(torch.int16).numpy()}
        return {key: tree.numpy()}
    return {f"{key}#scalar": np.asarray(tree)}


def _orbax_diff(torch, got, want, path="") -> list:
    """Paths where the host tree ``got`` differs from ``want`` (tensors on
    any device, bit for bit, one leaf on the card at a time)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path or "<root>"]
        return [p for k in want for p in _orbax_diff(torch, got[k], want[k], f"{path}.{k}")]
    if isinstance(want, torch.Tensor):
        ok = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
              and got.shape == want.shape and torch.equal(got.to(want.device), want))
        return [] if ok else [path]
    if isinstance(want, np.ndarray):  # the optax hyperparameters, 0-d
        ok = (isinstance(got, torch.Tensor) and str(got.dtype) == f"torch.{want.dtype.name}"
              and np.array_equal(got.numpy(), want))
        return [] if ok else [path]
    return [] if got == want and type(got) is type(want) else [path]


def orbax_phase(torch, dk, glue, binf, tmp, dcp_read: dict):
    """Orbax checkpoints (``train/orbax_format.py``, ``train/ocdbt.py``,
    zstd through ``train/zstd.py``): (a) the committed JAX-written fixture
    read bit-equal to its expected leaves; (b) a full-width fused-Adam
    Trainer's state after two steps (731,945,857 params and both Adam
    moments, float32: 8.78 GB) written by ``save_checkpoint_orbax`` (seconds
    to return and to commit), its params read alone (seconds, GB/s, bytes
    read against the params' stored bytes, within 1 %) and the whole state
    (seconds), both bit-equal to the state written, beside phase 21's
    params-only ``.dcp`` restore; (c) a 10 s request served from that
    directory through ``best_checkpoint`` (300 launches of each glue
    kernel; the waveform equal to the same weights served from memory);
    (d) ``fit(resume=True)`` from it for one epoch of 2 steps (20 dropout
    launches, a finite loss). The card's machine has no h5py, so ``fit``
    reads seeded chunks from arrays (``loop.process_data`` returns
    ``ChunkDataset.from_arrays``) instead of an HDF5 file. Returns
    (dropout launches, glue launches)."""
    from ml_music_style_transfer_tpu_torch.compat import weights
    from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
    from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
    from ml_music_style_transfer_tpu_torch.infer import synthesize as S
    from ml_music_style_transfer_tpu_torch.scripts.bench_train import host_arrays
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train import loop as loop_mod
    from ml_music_style_transfer_tpu_torch.train import ocdbt, orbax_format, zstd
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer, stage_batch

    t_phase = time.perf_counter()
    print(f"orbax: zstd route ctypes on libzstd.so.1, version {zstd.version()}")
    # (a) the committed fixture, compressed by tensorstore's zstd
    root = os.path.dirname(os.path.abspath(__file__))
    got = _flat_leaves(torch, orbax_format.read(os.path.join(root, ORBAX_FIXTURE)))
    want = dict(np.load(os.path.join(root, ORBAX_EXPECTED)))
    bad = sorted(set(got) ^ set(want)) or [k for k in want if got[k].dtype != want[k].dtype
                                            or not np.array_equal(got[k], want[k])]
    check(not bad, f"orbax: the JAX-written fixture differs at {bad[:5]}")
    print(f"orbax: the JAX-written fixture read bit-equal to its expected leaves "
          f"({len(want)} leaves: bf16, f32, int32, scalars, a 4-chunk array, an empty node)")

    # (b) the full-width state
    cuda = torch.device("cuda")
    raw = host_arrays(16, seed=23)
    cond_key, target_key = sorted(k for k in raw if k.startswith("spec_"))[:2]
    batch = stage_batch({"midi": raw["pianoroll"], "onoff": raw["onoff"],
                         "cond": np.ascontiguousarray(raw[cond_key].transpose(0, 2, 1)),
                         "target": np.ascontiguousarray(raw[target_key].transpose(0, 2, 1)),
                         "weight": np.ones((16,), np.float32)}, cuda)
    del raw
    exp_root = os.path.join(tmp, "runs")
    cfg = TrainConfig(batch_size=16, epochs=2, exp_name="orbax")
    tr = Trainer(ModelConfig(), cfg, exp_root=exp_root, device="cuda")
    tr.init_state(0)
    n_params = sum(p.numel() for p in tr.model.parameters())
    check(n_params == FULL_WIDTH_PARAMS, f"orbax: {n_params} params")
    for s in range(2):
        tr.train_step(batch, s)
    del batch
    state = tr.jax_state_dict(1)
    exp_dir = tr.exp_dir
    os.makedirs(exp_dir)
    exp = ckpt.ExperimentState(1, 1, "orbax")
    exp.best_epoch, exp.best_loss = 1, -1.0  # the resumed epoch writes no checkpoint
    exp.save(exp_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint_orbax(exp_dir, 1, state)
    ret_s = time.perf_counter() - t0
    ckpt.wait_for_async_saves()
    commit_s = time.perf_counter() - t0
    with ocdbt.Database(path) as db:
        sizes = {k: (len(v) if isinstance(v, bytes) else v.length) for k, v in db.items()}
    stored = sum(sizes.values())
    params_stored = sum(n for k, n in sizes.items() if k.startswith(b"params."))
    state_gb = 3 * 4 * n_params / 1e9
    print(f"orbax: state {state_gb:.2f} GB (params + Adam moments, float32); "
          f"save_checkpoint_orbax returned after {ret_s:.3f} s (page-locked staging), committed "
          f"after {commit_s:.2f} s ({stored / 1e9:.3f} GB of zstd-1 chunks, {len(sizes)} keys)")

    stats: dict = {}
    t = time.perf_counter()
    params = orbax_format.read(path, keys=("params",), stats=stats)["params"]
    params_s = time.perf_counter() - t
    diff = _orbax_diff(torch, params, state["params"])
    check(not diff, f"orbax: the params-only read differs at {diff[:5]}")
    read_b = stats["value_bytes"]
    check(abs(read_b - params_stored) <= 0.01 * params_stored,
          f"orbax: the params-only read read {read_b} B of {params_stored} B stored")
    t = time.perf_counter()
    whole = orbax_format.read(path)
    whole_s = time.perf_counter() - t
    diff = _orbax_diff(torch, whole, weights.flax_state_dict(state))
    check(not diff, f"orbax: the full read differs at {diff[:5]}")
    params_gb = 4 * n_params / 1e9
    print(f"orbax: params-only read {params_s:.2f} s ({params_gb / params_s:.2f} GB/s of "
          f"params), {read_b / 1e9:.3f} GB read of {params_stored / 1e9:.3f} GB stored under "
          f"params (+ {stats['node_bytes'] / 1e6:.3f} MB of B-tree), {stats['chunks']} chunks; "
          f"full read {whole_s:.2f} s ({state_gb / whole_s:.2f} GB/s); both bit-equal to the "
          f"state written (page cache warm); phase 21's .dcp params-only restore "
          f"{dcp_read['s']:.2f} s, {dcp_read['bytes'] / 1e9:.3f} GB read")
    served = weights.from_jax_params(state["params"])
    del whole, params, state, tr
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a 10 s request served from the directory through best_checkpoint
    check(ckpt.best_checkpoint(exp_dir) == (path, 1), "orbax: best_checkpoint")
    midi, wav = binf.make_clip(tmp, "orbax", 10.0, 24)
    S.clear_caches()
    waves = {}
    for what, kw in (("orbax", {}), ("memory", {"params": served})):
        synth = S.AudioSynthesizer(exp_dir, midi, wav, model_cfg=ModelConfig(), device="cuda",
                                   **kw)
        glue.reset_launches()
        t = time.perf_counter()
        waves[what] = synth.synthesize_waveform(n_iter=N_ITER)
        dt = time.perf_counter() - t
        gl = counted(glue, N_ITER, f"orbax: request ({what})")
        print(f"orbax: 10 s request, weights from {what}: {dt:.3f} s (the first builds the model)")
        del synth
    y = waves["orbax"]
    check(y.ndim == 1 and y.shape[0] % 256 == 0 and y.shape[0] >= 9 * 44100
          and bool(np.isfinite(y).all()), f"orbax: waveform shape {y.shape} or values")
    check(np.array_equal(y, waves["memory"]),
          "orbax: serving from the orbax directory differs from the same weights from memory")
    del served, waves
    S.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()

    # (d) fit resumes from it: one epoch of 2 steps and its evaluation
    train_ds = ChunkDataset.from_arrays(host_arrays(32, seed=25), seed=0)
    test_ds = ChunkDataset.from_arrays(host_arrays(16, seed=26), seed=1)
    real = loop_mod.process_data
    loop_mod.process_data = lambda *a, **k: (train_ds, test_ds)
    dk.reset_launches()
    try:
        t = time.perf_counter()
        _, exp = Trainer(ModelConfig(), cfg, exp_root=exp_root, device="cuda").fit(
            "seeded-arrays", resume=True)
        fit_s = time.perf_counter() - t
    finally:
        loop_mod.process_data = real
    dropout = dk.LAUNCHES["dropout_apply"] + dk.LAUNCHES["dropout_grad"]
    check(dk.LAUNCHES["dropout_apply"] == dk.LAUNCHES["dropout_grad"] == 20,
          f"orbax: dropout launches {dict(dk.LAUNCHES)} in the resumed epoch of 2 steps")
    check(len(exp.loss_history) == 1 and bool(np.isfinite(exp.loss_history).all())
          and bool(np.isfinite(exp.test_loss_history).all()),
          f"orbax: resumed losses {exp.loss_history} {exp.test_loss_history}")
    print(f"orbax: fit(resume=True) from {os.path.basename(path)}: init, read, load, 2 steps "
          f"and the evaluation {fit_s:.2f} s, loss {exp.loss_history[0]:.6f}, test loss "
          f"{exp.test_loss_history[-1]:.6f}; dropout launches 10 + 10 per step")
    shutil.rmtree(exp_root)
    print(f"orbax: phase 22 card time {time.perf_counter() - t_phase:.1f} s")
    return dropout, 2 * gl


# ---- phase 23: orbax checkpoints on a mesh, each rank its own shards ----------

MESH_23 = {"data": 2, "model": 2}  # the mesh whose 4 ranks one process plays


def _chunk_sizes(path: str) -> tuple[dict, dict]:
    """({key: stored bytes}, {array name: its .zarray}) of the root
    database's listing of the orbax directory at ``path``."""
    from ml_music_style_transfer_tpu_torch.train import ocdbt

    with ocdbt.Database(path) as db:
        items = list(db.items())
        sizes = {k: len(v) if isinstance(v, bytes) else v.length for k, v in items}
        zarrays = {k[:-len(b"/.zarray")].decode(): json.loads(db.read(v))
                   for k, v in items if k.endswith(b"/.zarray")}
    return sizes, zarrays


def _chunk_bytes(listing: tuple[dict, dict], regions: dict, tops) -> tuple[int, int]:
    """(stored bytes of the chunks that meet each region's box, and of the
    ``.zarray``s, under the top-level trees ``tops``; stored bytes of every
    chunk there), from a directory's ``_chunk_sizes``."""
    sizes, zarrays = listing
    meet = whole = 0
    for name, z in zarrays.items():
        keys = tuple(name.split("."))
        if keys[0] not in tops:
            continue
        whole += sum(n for k, n in sizes.items() if k.startswith(f"{name}/".encode()))
        meet += sizes[f"{name}/.zarray".encode()]
        lo, size = regions.get(keys, ((0,) * len(z["shape"]), z["shape"]))
        ranges = [range(o // c, -(-(o + n) // c)) for o, n, c in zip(lo, size, z["chunks"])]
        for g in itertools.product(*ranges) if int(np.prod(size)) else []:
            meet += sizes[f"{name}/{'.'.join(map(str, g)) if g else '0'}".encode()]
    return meet, whole


def orbax_mesh_phase(torch, dk, glue, binf, tmp):
    """Orbax checkpoints on a mesh (ROADMAP 7b/7c): (a) a full-width fused-Adam
    ``Trainer`` on a (1, 1) NCCL mesh with ZeRO-1 takes two steps (10 + 10
    dropout launches each) and saves through ``fit``'s mesh path,
    ``save_checkpoint_orbax(orbax_state)`` (seconds to return and to
    commit; one ``ocdbt.process_0/``), its whole read bit-equal to
    ``jax_state_dict`` of the same state; (b) this process plays the 4
    ranks of a (2, 2) ZeRO-1 mesh in turn: each rank's blocks cut on the
    card from that state (``loop.rank_orbax_state``: the placements of
    ``parallel/mesh.placements`` on the (2, 2) checkpoint mesh, with no
    process group) and written by ``orbax_format.write_shards`` (seconds
    each), then ``commit``; the directory's whole read bit-equal to (a)'s,
    each rank's region read bit-equal to its blocks, its bytes read within
    1 % of the stored bytes of the chunks that meet its blocks (seconds,
    and its share of the state's stored bytes); (c) a 10 s request served
    from that directory through ``best_checkpoint`` equal to the same
    weights from memory (300 launches of each glue kernel per request);
    (d) ``fit(resume=True)`` from it on the (1, 1) mesh, one epoch of 2
    steps (20 + 20 dropout launches, finite losses). Returns (dropout
    launches, glue launches)."""
    import torch.distributed as dist

    from ml_music_style_transfer_tpu_torch.compat import weights
    from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
    from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
    from ml_music_style_transfer_tpu_torch.infer import synthesize as S
    from ml_music_style_transfer_tpu_torch.parallel import mesh as pmesh
    from ml_music_style_transfer_tpu_torch.scripts.bench_train import host_arrays
    from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
    from ml_music_style_transfer_tpu_torch.train import loop as loop_mod
    from ml_music_style_transfer_tpu_torch.train import orbax_format
    from ml_music_style_transfer_tpu_torch.train.loop import Trainer, stage_batch

    t_phase = time.perf_counter()
    spans = {}  # what the phase's seconds went to

    def span(name, t0):
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0

    cuda = torch.device("cuda")
    pmesh.distributed_init("cuda", init_method=f"tcp://localhost:{pmesh.free_port()}",
                           world_size=1, rank=0)
    mesh = pmesh.make_mesh(1, 1, device="cuda")
    exp_root = os.path.join(tmp, "runs")

    # (a) the (1, 1) mesh's save, fit's mesh path
    raw = host_arrays(16, seed=27)
    cond_key, target_key = sorted(k for k in raw if k.startswith("spec_"))[:2]
    batch = stage_batch({"midi": raw["pianoroll"], "onoff": raw["onoff"],
                         "cond": np.ascontiguousarray(raw[cond_key].transpose(0, 2, 1)),
                         "target": np.ascontiguousarray(raw[target_key].transpose(0, 2, 1)),
                         "weight": np.ones((16,), np.float32)}, cuda)
    del raw
    cfg = TrainConfig(batch_size=16, epochs=2, exp_name="mesh11", zero_opt=True)
    tr = Trainer(ModelConfig(), cfg, exp_root=exp_root, device="cuda", mesh=mesh)
    tr.init_state(0)
    check(type(tr.optimizer).__name__ == "ZeroOptimizer", "orbax mesh: the Trainer has no ZeRO")
    dk.reset_launches()
    for s in range(2):
        tr.train_step(tr.shard_batch(batch), s)
    torch.cuda.synchronize()
    check(dk.LAUNCHES["dropout_apply"] == dk.LAUNCHES["dropout_grad"] == 20,
          f"orbax mesh: dropout launches {dict(dk.LAUNCHES)} after 2 steps")
    dropout = dk.LAUNCHES["dropout_apply"] + dk.LAUNCHES["dropout_grad"]
    del batch
    span("(a) trainer and 2 steps", t_phase)
    os.makedirs(tr.exp_dir)
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint_orbax(tr.exp_dir, 1, tr.orbax_state(1))
    ret_s = time.perf_counter() - t0
    ckpt.wait_for_async_saves()
    commit_s = time.perf_counter() - t0
    check(sorted(d for d in os.listdir(path) if d.startswith("ocdbt.")) == ["ocdbt.process_0"],
          f"orbax mesh: {sorted(os.listdir(path))}")
    t = time.perf_counter()
    whole = orbax_format.read(path)
    read_s = time.perf_counter() - t
    t = time.perf_counter()
    diff = _orbax_diff(torch, whole, weights.flax_state_dict(tr.jax_state_dict(1)))
    check(not diff, f"orbax mesh: the (1, 1) mesh's directory differs at {diff[:5]}")
    span("(a) check", t)
    spans["(a) save"], spans["(a) read"] = commit_s, read_s
    print(f"orbax mesh: (a) (1, 1) NCCL mesh, ZeRO-1, full width: save_checkpoint_orbax of "
          f"orbax_state returned after {ret_s:.3f} s, committed after {commit_s:.2f} s (one "
          f"ocdbt.process_0/); whole read {read_s:.2f} s, bit-equal to jax_state_dict")

    # (b) the 4 ranks of a (2, 2) ZeRO-1 mesh, played in turn
    t = time.perf_counter()
    state = tr.state_dict(1)
    box = lambda tree: {k: (b.shape, b.offset, b.size, b.dtype, b.write)  # noqa: E731
                        for k, b in orbax_format.shards(tree).items()}
    check(box(loop_mod.rank_orbax_state(state, cfg, {"data": 1, "model": 1}, 0))
          == box(tr.orbax_state(1)),
          "orbax mesh: rank_orbax_state's blocks on the (1, 1) mesh differ from orbax_state's")
    span("(b) state", t)
    exp_dir = os.path.join(exp_root, "mesh22")
    play = ckpt.checkpoint_path(exp_dir, 1, "orbax")
    os.makedirs(f"{play}.tmp")
    entries, blocks0 = [], None
    for r in range(4):
        t = time.perf_counter()
        blocks = loop_mod.rank_orbax_state(state, cfg, MESH_23, r)
        entries.append(orbax_format.write_shards(f"{play}.tmp", r, blocks))
        span("(b) writes", t)
        n = sum(math.prod(b.size) * b.data.element_size()
                for b in orbax_format.shards(blocks).values() if b.write)
        print(f"orbax mesh: (b) rank {r} of {MESH_23}: write_shards {time.perf_counter() - t:.2f} "
              f"s ({n / 1e9:.3f} GB of blocks it writes, {len(entries[-1])} keys)")
        if r == 0:
            blocks0 = orbax_format.layout(blocks)
        del blocks
    t = time.perf_counter()
    orbax_format.commit(f"{play}.tmp", play, blocks0, entries)
    print(f"orbax mesh: (b) commit {time.perf_counter() - t:.2f} s")
    again = orbax_format.read(play)
    diff = _orbax_diff(torch, again, whole)
    check(not diff, f"orbax mesh: the 4-rank directory's whole read differs from (a)'s at "
                    f"{diff[:5]}")
    del again, whole
    span("(b) commit, whole read and check", t)
    tops = ("params", "opt_state", "epoch", "scheduler")
    listing = _chunk_sizes(play)
    for r in range(4):
        t_rank = time.perf_counter()
        blocks = orbax_format.shards(loop_mod.rank_orbax_state(state, cfg, MESH_23, r))
        stats = {}
        t = time.perf_counter()
        got = orbax_format.read(play, keys=tops, stats=stats,
                                regions={k: (b.offset, b.size) for k, b in blocks.items()})
        dt = time.perf_counter() - t
        bad = []
        for keys, b in blocks.items():
            node = got
            for k in keys:
                node = node[k]
            if node.dtype != b.dtype or not torch.equal(node.to(cuda), b.data):
                bad.append(".".join(keys))
        check(not bad, f"orbax mesh: rank {r}'s region read differs at {bad[:5]}")
        meet, stored = _chunk_bytes(listing, {k: (b.offset, b.size) for k, b in blocks.items()},
                                    tops)
        check(abs(stats["value_bytes"] - meet) <= 0.01 * meet,
              f"orbax mesh: rank {r} read {stats['value_bytes']} B, the chunks that meet its "
              f"blocks hold {meet} B")
        print(f"orbax mesh: (b) rank {r} region read {dt:.2f} s, {stats['value_bytes'] / 1e9:.3f}"
              f" GB read ({stats['chunks']} chunks) of {stored / 1e9:.3f} GB stored: "
              f"{stats['value_bytes'] / stored:.3f} of the state; bit-equal to its blocks")
        del got, blocks
        span("(b) region reads and checks", t_rank)
    served = {k: v.clone() for k, v in tr.model.state_dict().items()}
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a 10 s request served from the 4-rank directory
    t_c = time.perf_counter()
    exp = ckpt.ExperimentState(1, 1, "mesh22")
    exp.best_epoch, exp.best_loss = 1, -1.0  # the resumed epoch writes no checkpoint
    exp.save(exp_dir)
    check(ckpt.best_checkpoint(exp_dir) == (play, 1), "orbax mesh: best_checkpoint")
    midi, wav = binf.make_clip(tmp, "orbaxmesh", 10.0, 28)
    S.clear_caches()
    waves = {}
    for what, kw in (("directory", {}), ("memory", {"params": served})):
        synth = S.AudioSynthesizer(exp_dir, midi, wav, model_cfg=ModelConfig(), device="cuda",
                                   **kw)
        glue.reset_launches()
        t = time.perf_counter()
        waves[what] = synth.synthesize_waveform(n_iter=N_ITER)
        dt = time.perf_counter() - t
        gl = counted(glue, N_ITER, f"orbax mesh: request ({what})")
        print(f"orbax mesh: (c) 10 s request, weights from the {what}: {dt:.3f} s")
        del synth
    y = waves["directory"]
    check(y.ndim == 1 and y.shape[0] >= 9 * 44100 and bool(np.isfinite(y).all()),
          f"orbax mesh: waveform shape {y.shape} or values")
    check(np.array_equal(y, waves["memory"]),
          "orbax mesh: serving from the 4-rank directory differs from the same weights in memory")
    del served, waves
    S.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    span("(c) serving", t_c)

    # (d) fit resumes from it on the (1, 1) mesh
    train_ds = ChunkDataset.from_arrays(host_arrays(32, seed=29), seed=0)
    test_ds = ChunkDataset.from_arrays(host_arrays(16, seed=30), seed=1)
    real = loop_mod.process_data
    loop_mod.process_data = lambda *a, **k: (train_ds, test_ds)
    dk.reset_launches()
    try:
        t = time.perf_counter()
        _, exp = Trainer(ModelConfig(), dataclasses.replace(cfg, exp_name="mesh22"),
                         exp_root=exp_root, device="cuda", mesh=mesh).fit(
            "seeded-arrays", resume=True)
        fit_s = time.perf_counter() - t
    finally:
        loop_mod.process_data = real
    check(dk.LAUNCHES["dropout_apply"] == dk.LAUNCHES["dropout_grad"] == 20,
          f"orbax mesh: dropout launches {dict(dk.LAUNCHES)} in the resumed epoch of 2 steps")
    dropout += dk.LAUNCHES["dropout_apply"] + dk.LAUNCHES["dropout_grad"]
    check(len(exp.loss_history) == 1 and bool(np.isfinite(exp.loss_history).all())
          and bool(np.isfinite(exp.test_loss_history).all()),
          f"orbax mesh: resumed losses {exp.loss_history} {exp.test_loss_history}")
    print(f"orbax mesh: (d) fit(resume=True) on the (1, 1) mesh from the 4-rank directory: "
          f"init, region reads, load, 2 steps and the evaluation {fit_s:.2f} s, loss "
          f"{exp.loss_history[0]:.6f}; dropout launches 10 + 10 per step")
    spans["(d) fit"] = fit_s
    dist.destroy_process_group()
    shutil.rmtree(exp_root)
    total = time.perf_counter() - t_phase
    print(f"orbax mesh: phase 23 card time {total:.1f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in spans.items())
          + f", the rest {total - sum(spans.values()):.2f} s")
    return dropout, 2 * gl


# ---- phase 24: Griffin-Lim's dispatch by shape, and the last scripts ------------

DISPATCH_ITERS = 4  # Griffin-Lim iterations of each unsupported input


def _dispatch_inputs(torch):
    """(name, magnitude on the card, griffinlim keyword arguments): the
    inputs the glue kernels do not take, each a seeded harmonic clip's
    |STFT|, as tests/test_torch_port_gl_dispatch.py builds them."""
    from ml_music_style_transfer_tpu_torch.ops import stft as tstft

    def magnitude(n_frames, lead=()):
        t = torch.arange(256 * (n_frames - 1), dtype=torch.float64) / 44100.0
        y = sum(a * torch.sin(2 * math.pi * f * t)
                for a, f in ((0.5, 220.0), (0.25, 661.0), (0.1, 1750.0)))
        mag = tstft.stft(y.float().cuda(), 2048, 256).abs()
        scale = torch.arange(1, math.prod(lead) + 1, device="cuda", dtype=torch.float32)
        return (scale[:, None, None] * mag).reshape(*lead, *mag.shape)

    return [("length", magnitude(40), dict(length=10084)),
            ("win_length 1024", magnitude(40), dict(win_length=1024)),
            ("hop 128", magnitude(40), dict(hop_length=128)),
            ("hop 512", magnitude(40), dict(hop_length=512)),
            ("hop 1024", magnitude(40), dict(hop_length=1024)),
            ("8 frames", magnitude(8), {}),
            ("20 frames", magnitude(20), {}),
            ("(2, 2, 1025, 20) batch", magnitude(20, (2, 2)), {})]


def dispatch_scripts_phase(torch, dk, glue, tstft, tmp) -> int:
    """Griffin-Lim's dispatch by shape on the card, then the port's last
    scripts at reduced sizes. (a) Each input the glue kernels do not take
    (a ``length``, ``win_length`` 1024, hops 128/512/1024, 8 and 20 frames,
    a (2, 2, 1025, 20) batch) answers under the default arguments on the
    istft -> stft loop with 0 glue launches, within 1e-4 of the peak of the
    same call with ``use_pallas_glue=False``, and raises under ``True``; a
    1720-frame clip under the default launches each glue kernel 300 times;
    ``stft``'s ``pad_mode`` (reflect, constant, edge) on the card within
    1e-4 of the peak of the CPU's. (b) ``scripts/bench_inference.py`` at
    full width (a 10 s clip, 30 iterations, no daemon, the one-pass probe
    up to 240 s), ``bench_preprocess.py`` (its full 4 songs of 90 s),
    ``bench_dft_gl.py`` (30 iterations) and ``bench_gl_kernels.py`` through
    their ``main``s, each with its own checks; the JSONs are written under
    ``tmp``. Returns the glue kernels' launches of the phase: every one is
    a Griffin-Lim iteration (the dropout kernel's launches in
    ``bench_gl_kernels.py`` time it against its plain version, as phase 10
    does, and stay out of its count)."""
    from ml_music_style_transfer_tpu_torch.infer import synthesize as synth_mod
    from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
    from ml_music_style_transfer_tpu_torch.scripts import (bench_dft_gl, bench_gl_kernels,
                                                           bench_inference, bench_preprocess)

    t_phase = time.perf_counter()
    gl_launches = 0
    for name, mag, kw in _dispatch_inputs(torch):
        phase = 2 * np.pi * torch.rand(mag.shape, generator=torch.Generator().manual_seed(1))
        glue.reset_launches()
        with torch.inference_mode():
            got = tgl.griffinlim(mag, n_iter=DISPATCH_ITERS, init_phase=phase, device="cuda",
                                 **kw)
            torch.cuda.synchronize()
            launched = dict(glue.LAUNCHES)
            want = tgl.griffinlim(mag, n_iter=DISPATCH_ITERS, init_phase=phase,
                                  use_pallas_glue=False, device="cuda", **kw)
        err = float((got - want).abs().max() / want.abs().max())
        try:
            tgl.griffinlim(mag, n_iter=1, init_phase=phase, use_pallas_glue=True, device="cuda",
                           **kw)
            refused = ""
        except ValueError as e:
            refused = str(e)
        print(f"dispatch: {name}: output {tuple(got.shape)}, glue launches {launched}, "
              f"max_abs_err/peak against use_pallas_glue=False {err:.3e} (tolerance 1e-4); "
              f"use_pallas_glue=True raises: {bool(refused)}")
        check(not any(launched.values()), f"dispatch: {name} launched the glue kernels")
        check(err <= 1e-4, f"dispatch: {name} disagrees with the istft -> stft loop")
        check("at least 24 frames" in refused, f"dispatch: {name}: use_pallas_glue=True "
              f"did not raise naming the rule ({refused!r})")
    spec = torch.rand((1025, 1720), generator=torch.Generator().manual_seed(2),
                      device="cpu").cuda() * 8
    glue.reset_launches()
    with torch.inference_mode():
        wav = tgl.griffinlim_from_log_power(spec, n_iter=N_ITER, device="cuda")
        torch.cuda.synchronize()
    gl_launches += counted(glue, N_ITER, "dispatch: a 1720-frame clip")
    check(wav.shape == (256 * 1719,) and bool(torch.isfinite(wav).all()),
          "dispatch: the 1720-frame clip's waveform")
    print(f"dispatch: a 1720-frame clip under the default arguments: {dict(glue.LAUNCHES)} "
          f"launches ({N_ITER} iterations)")
    y = torch.randn((2, 20000), generator=torch.Generator().manual_seed(5)) + 0.5
    for mode in ("reflect", "constant", "edge"):
        a = tstft.stft(y.cuda(), 2048, 256, pad_mode=mode).cpu()
        b = tstft.stft(y, 2048, 256, pad_mode=mode)
        e = float((a - b).abs().max() / b.abs().max())
        print(f"dispatch: stft pad_mode={mode!r} card vs CPU max_abs_err/peak {e:.3e} "
              f"(tolerance 1e-4)")
        check(e <= 1e-4, f"stft pad_mode={mode!r} differs between the card and the CPU")
    t_dispatch = time.perf_counter() - t_phase
    runs = {}

    def run(name, fn, argv):
        glue.reset_launches()
        dk.reset_launches()
        t = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        runs[name] = dict(s=time.perf_counter() - t, glue=dict(glue.LAUNCHES),
                          dropout=dict(dk.LAUNCHES))
        print(f"scripts: {name} {runs[name]['s']:.1f} s, glue launches {runs[name]['glue']}, "
              f"dropout launches {runs[name]['dropout']}", flush=True)
        synth_mod.clear_caches()
        gc.collect()
        torch.cuda.empty_cache()
        return out

    n_iter = 30
    metrics = run("bench_inference", bench_inference.main, [
        "--width-mult", "1.0", "--seconds", "10", "--daemon-requests", "0",
        "--probe-cap-seconds", "240", "--n-iter", str(n_iter), "--out-dir", tmp])
    with open(os.path.join(tmp, "SERVING_WHOLECLIP_H100.json")) as f:
        wc = json.load(f)
    probe = wc["max_onepass_probe"]
    # 4 serving runs, 4 Griffin-Lim, 4 whole clips, 4 x 4 bulk clips, the probe's clips
    want = n_iter * (4 + 4 + 4 + 16) + probe["n_iter"] * len(probe["seconds"])
    check(set(metrics) == {"serving_s_per_30s_clip", "griffinlim_s_per_10s_clip",
                           "whole_clip_s_per_30s_clip", "batch_griffinlim_s_per_clip"},
          f"bench_inference metrics {sorted(metrics)}")
    check(all(math.isfinite(v) for v in wc["divergence"].values() if isinstance(v, float)),
          "bench_inference: divergence not finite")
    check(probe["longest_ok_s"] >= 240.0, f"bench_inference: longest one-pass clip {probe}")
    gl_launches += counted(glue, want, "bench_inference")
    print(f"scripts: bench_inference whole clip at full width: {json.dumps(wc)}")

    # at its full size: at 2 songs of 30 s the auto probe's fixed ~0.06 s made
    # auto 1.31x the best manual 0.19 s on an H100 (PERF.md)
    pp = run("bench_preprocess", bench_preprocess.main, ["--out", os.path.join(tmp, "pp.json")])
    check(pp["spec_max_abs_diff"] < 1e-3, f"bench_preprocess: spectrograms differ by "
          f"{pp['spec_max_abs_diff']:.3e} from the reference-shaped emulation")
    check(not any(runs["bench_preprocess"]["glue"].values()),
          "bench_preprocess launched the glue kernels")

    dft = run("bench_dft_gl", bench_dft_gl.main, ["--n-iter", "30"])
    for v in ("dft_bf16", "dft_tf32", "dft_f32"):
        check(abs(dft[v]["spectral_err"] - dft["fft"]["spectral_err"]) < 1e-2,
              f"bench_dft_gl: {v}'s spectral error {dft[v]['spectral_err']:.5f} against the "
              f"fft loop's {dft['fft']['spectral_err']:.5f}")
    launched = set(runs["bench_dft_gl"]["glue"].values())
    check(len(launched) == 1, f"bench_dft_gl: glue launches {runs['bench_dft_gl']['glue']}")
    gl_launches += launched.pop()

    kern = run("bench_gl_kernels", bench_gl_kernels.main, [])
    check(kern["griffinlim"]["waveform_rel_diff"] < 1.0,
          "bench_gl_kernels: Griffin-Lim with and without the glue kernels diverged")
    gl_launches += counted(glue, 4 * N_ITER, "bench_gl_kernels")  # a warm-up and 3 timed runs
    print(f"phase 24: dispatch {t_dispatch:.1f} s, "
          + ", ".join(f"{k} {v['s']:.1f} s" for k, v in runs.items())
          + f"; glue launches {gl_launches} per kernel")
    return gl_launches


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


def timed(name: str, fn, *args):
    """``fn(*args)``, then a line with the phase's seconds."""
    t = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
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
    from ml_music_style_transfer_tpu_torch.ops.kernels import relayout as rl
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

    errs, timing = timed("3 (glue kernels vs plain)", kernel_phase, torch, glue, tstft)
    fc.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        launches, warm, state = timed("4 (serving path)", main_path, torch, glue, dk, binf, tmp)
        timed("5 (profile)", profile_phase, torch, warm)
        cfg = warm.model_cfg

        def make_synth(midi, wav):  # the serving cache's model for `state`
            return synth_mod.AudioSynthesizer(tmp, midi, wav, model_cfg=cfg, params=state,
                                              device="cuda")

        gl_launches = sum(launches.values()) // 2
        gl_launches += timed("6 (whole clip)", whole_clip_phase, torch, glue, tstft, binf,
                             make_synth, tmp, errs)
        gl_launches += timed("7 (batch)", batch_phase, torch, glue, binf, make_synth, tmp)
        gl_launches += timed("8 (daemon)", daemon_phase, torch, glue, binf, make_synth, tmp)
        gl_launches += timed("9 (dft)", dft_phase, torch, glue, tstft, binf, warm, tmp)
        print(f"launches of each glue kernel over the serving paths (tiled, whole clip, batch, "
              f"daemon, dft): {gl_launches}")
    del warm, make_synth  # phases 17-19 serve the phase-4 weights (`state`) again
    synth_mod.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    check(not any(fc.LAUNCHES.values()), "serving launched the fused conv kernel")
    dropout_err, dropout_t = timed("10 (dropout kernel vs plain)", dropout_phase, torch, dk)
    timed("10b (relayout kernel and the channel-last step)", layout_phase, torch, rl)
    dropout_launches, tr, fed_step = timed("11 (training)", train_phase, torch, dk, glue)
    glue.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        data_launches, resident, fed = timed("13 (data path)", data_phase, torch, dk, tr, tmp)
    scale_launches, scale = timed("14 (store at scale)", scale_phase, torch, dk, tr)
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
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        opt_dropout, opt_gl = timed("15 (optimizer options)", options_phase, torch, dk, glue,
                                    binf, tmp)
    dropout_launches += opt_dropout
    gl_launches += opt_gl
    check(not any(fc.LAUNCHES.values()), "the options phase launched the fused conv kernel")
    gc.collect()
    torch.cuda.empty_cache()
    timed("16 (autoencoder)", autoencoder_phase, torch, dk, glue, fc, binf)
    gc.collect()
    torch.cuda.empty_cache()
    timed("16b (Spectrogram Diffusion)", sdiff_phase, torch, dk)
    print("fused conv kernel launches on the serving, training, data, options and autoencoder "
          "paths: 0 (the model keeps cuDNN's conv, as the JAX model keeps XLA's)")
    for phase in ("17 (export)", "18 (support code)", "19 (soak)"):
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            if phase.startswith("17"):
                n, ref = timed(phase, export_phase, torch, glue, tstft, binf, state, cfg, tmp)
                gl_launches += n + timed("17b (AOTInductor packages)", aoti_phase, torch, glue,
                                         tstft, ref, state, tmp)
                del ref
            elif phase.startswith("18"):
                nan_dropout, support_gl = timed(phase, support_phase, torch, dk, glue, binf, state,
                                                cfg, tmp)
                dropout_launches += nan_dropout
                gl_launches += support_gl
            else:
                gl_launches += timed(phase, soak_phase, torch, glue, state, cfg, tmp)
    check(not any(fc.LAUNCHES.values()), "phases 17-19 launched the fused conv kernel")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        md_dropout, md_gl, md_err = timed("20 (multi-device)", multidevice_phase, torch, dk,
                                          glue, binf, state, cfg, tmp)
    dropout_launches += md_dropout
    dropout_err = max(dropout_err, md_err)
    gl_launches += md_gl
    check(not any(fc.LAUNCHES.values()), "phase 20 launched the fused conv kernel")
    del state
    synth_mod.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ck_dropout, ck_gl, dcp_read = timed("21 (checkpoints, WAV decoder, profiles)",
                                            checkpoint_phase, torch, dk, glue, binf, tmp)
    dropout_launches += ck_dropout
    gl_launches += ck_gl
    check(not any(fc.LAUNCHES.values()), "phase 21 launched the fused conv kernel")
    synth_mod.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ob_dropout, ob_gl = timed("22 (orbax checkpoints)", orbax_phase, torch, dk, glue, binf,
                                  tmp, dcp_read)
    dropout_launches += ob_dropout
    gl_launches += ob_gl
    check(not any(fc.LAUNCHES.values()), "phase 22 launched the fused conv kernel")
    synth_mod.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        om_dropout, om_gl = timed("23 (orbax on a mesh)", orbax_mesh_phase, torch, dk, glue,
                                  binf, tmp)
    dropout_launches += om_dropout
    gl_launches += om_gl
    check(not any(fc.LAUNCHES.values()), "phase 23 launched the fused conv kernel")
    synth_mod.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"launches over phases 3-23: {gl_launches} of each glue kernel, {dropout_launches} "
          "of the dropout kernel")
    with tempfile.TemporaryDirectory() as tmp:
        gl_launches += timed("24 (dispatch and scripts)", dispatch_scripts_phase, torch, dk, glue,
                             tstft, tmp)
    check(not any(fc.LAUNCHES.values()), "phase 24 launched the fused conv kernel")
    synth_mod.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    conv_launches, conv_err, conv_t = timed("12 (fused conv)", fused_conv_phase, torch, fc)

    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s, the build included")
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
