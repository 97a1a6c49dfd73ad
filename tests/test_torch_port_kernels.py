"""The Griffin-Lim glue kernel's wrapper contract (on the CPU) and the kernel
against its plain PyTorch version (on the card, ``cuda`` marker).

This file imports neither JAX nor the JAX package, so the card's tests run
on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py
"""
import numpy as np
import pytest
import torch

from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue as tglue

N_FFT, HOP = 2048, 256


def _glue_consts(nf, device="cpu"):
    window = torch.from_numpy(tstft.window_const(N_FFT, N_FFT)).to(device)
    inv = torch.from_numpy(
        tstft.wss_inv_const(N_FFT, N_FFT, HOP, nf).reshape(nf + 7, HOP)).to(device)
    return window, inv


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")


class TestWrapperContract:
    def _args(self, nf=32):
        return (torch.zeros((nf, N_FFT)), *_glue_consts(nf))

    def test_cpu_runs_plain_version_and_counts_no_launch(self):
        tglue.reset_launches()
        frames, window, inv = self._args()
        frames.normal_(generator=torch.Generator().manual_seed(0))
        g = tglue.gl_consistency_frames(frames, window, inv)
        assert g.shape == (32, N_FFT) and g.dtype == torch.float32
        assert torch.equal(g, tglue.gl_consistency_frames_reference(frames, window, inv))
        assert tglue.LAUNCHES == {"gl_ola_nola": 0, "gl_frame_window": 0}

    @pytest.mark.parametrize("bad", ["dtype", "frames", "inv_shape", "contiguous", "window"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        frames, window, inv = self._args()
        if bad == "dtype":
            frames = frames.double()
        elif bad == "frames":
            frames, window, inv = self._args(nf=20)  # fewer than 24 frames
        elif bad == "inv_shape":
            inv = inv[:-1]
        elif bad == "contiguous":
            frames = torch.zeros((N_FFT, 32)).t()
        else:
            window = torch.zeros(N_FFT + 8)
        with pytest.raises((TypeError, ValueError)):
            tglue.gl_consistency_frames(frames, window, inv)


@pytest.mark.cuda
class TestKernelOnCard:
    """Same inputs through the kernels and their plain versions on the card.
    The kernels round exactly as the plain versions do (no FMA contraction,
    same summation order); 1e-4 is the JAX kernel's own test tolerance."""

    @pytest.mark.parametrize("nf", [100, 5160])
    def test_kernels_match_plain_versions(self, nf):
        _need_card()
        gen = torch.Generator().manual_seed(nf)
        frames = torch.randn((nf, N_FFT), generator=gen).cuda()
        window, inv = _glue_consts(nf, "cuda")
        before = dict(tglue.LAUNCHES)
        y = tglue.ola_nola(frames, window, inv)
        g = tglue.frame_window(y, window, nf)
        y_ref = tglue.ola_nola_reference(frames, window, inv)
        g_ref = tglue.frame_window_reference(y_ref, window, nf)
        torch.cuda.synchronize()
        assert float((y - y_ref).abs().max()) <= 1e-4
        assert float((g - g_ref).abs().max()) <= 1e-4
        assert {k: tglue.LAUNCHES[k] - before[k] for k in before} == {
            "gl_ola_nola": 1, "gl_frame_window": 1}

    def test_griffinlim_through_kernels_matches_plain_path(self):
        _need_card()
        gen = torch.Generator().manual_seed(0)
        mag = torch.rand((1025, 200), generator=gen) * 3
        phase = 2 * np.pi * torch.rand(mag.shape, generator=gen)
        a = tgl.griffinlim(mag, n_iter=8, init_phase=phase, device="cuda")
        b = tgl.griffinlim(mag, n_iter=8, init_phase=phase, use_pallas_glue=False,
                           device="cuda")
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
