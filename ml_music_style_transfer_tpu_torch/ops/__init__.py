"""Compute ops: STFT/iSTFT, log-power compression, Griffin-Lim, kernels.

Submodules (imported as modules to avoid name shadowing):
  - ops.stft: stft/istft/log_power/inverse_log_power/log_power_stft
  - ops.griffinlim: griffinlim/gl_steps/griffinlim_from_log_power
  - ops.kernels: the CUDA kernels' wrappers and plain versions
  - ops.mel: mel filterbank and mel projection (spectral loss)
  - ops.reference: NumPy helpers for the window, NOLA and mel constants
"""
from . import griffinlim, kernels, mel, reference, stft  # noqa: F401
