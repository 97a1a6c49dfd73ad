"""The Griffin-Lim glue and fused-conv kernels' wrapper contracts (on the
CPU) and the kernels against their plain PyTorch versions (on the card,
``cuda`` marker).

This file imports neither JAX nor the JAX package, so the card's tests run
on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py
"""
import numpy as np
import pytest
import torch

from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.ops.kernels import fused_conv as tfc
from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue as tglue

N_FFT, HOP = 2048, 256
# (B, T, Cin, Cout): the JAX test's shape; Cin = 1025 (audio_down_0.conv1's
# unaligned rows) at T = 53; Cin and Cout off the 8-element bf16 alignment;
# everything ragged and smaller than a tile
CONV_SHAPES = [(3, 64, 96, 160), (2, 53, 1025, 136), (5, 40, 130, 72), (2, 7, 5, 3)]


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


def _conv_inputs(shape, dtype, device="cpu", seed=0):
    B, T, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, cin, cout)) / np.sqrt(3 * cin)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype), b.to(device)


class TestFusedConvWrapper:
    def test_cpu_runs_plain_version_and_counts_no_launch(self):
        tfc.reset_launches()
        x, w, b = _conv_inputs((2, 9, 6, 4), torch.float32)
        assert torch.equal(tfc.conv1x3_instnorm_lrelu(x, w, b),
                           tfc.conv1x3_instnorm_lrelu_reference(x, w, b))
        assert tfc.LAUNCHES == {"conv1x3_instnorm_lrelu": 0}

    @pytest.mark.parametrize("bad", ["dtype", "rank", "w_shape", "b_shape", "contiguous",
                                     "device", "grad"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        x, w, b = _conv_inputs((2, 9, 6, 4), torch.float32)
        err = ValueError
        if bad == "dtype":
            x, err = x.double(), TypeError
        elif bad == "rank":
            x = x[0]
        elif bad == "w_shape":
            w = w[:, :5]
        elif bad == "b_shape":
            b = b[:3]
        elif bad == "contiguous":
            x = x.transpose(0, 1).contiguous().transpose(0, 1)
        elif bad == "device":
            x, w, b = x.to("meta"), w.to("meta"), b.to("meta")
        else:
            w, err = w.requires_grad_(), RuntimeError
        with pytest.raises(err):
            tfc.conv1x3_instnorm_lrelu(x, w, b)

    def test_inputs_that_require_grad_pass_under_no_grad(self):
        x, w, b = _conv_inputs((2, 9, 6, 4), torch.float32)
        with torch.no_grad():
            y = tfc.conv1x3_instnorm_lrelu(x, w.requires_grad_(), b)
        assert y.shape == (2, 9, 4) and not y.requires_grad


@pytest.mark.cuda
class TestFusedConvOnCard:
    """The kernel against its plain version on the card. bfloat16: per
    element |kernel - plain| <= 2^-7 |plain| + 1e-3 (one bf16 rounding step:
    both sum the same exact bf16 products in float32, in other orders);
    float32: 2e-4, the JAX kernel test's tolerance (no TF32 in either)."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("shape", CONV_SHAPES)
    def test_kernel_matches_plain_version(self, shape, dtype):
        _need_card()
        torch.backends.cuda.matmul.allow_tf32 = False
        x, w, b = _conv_inputs(shape, dtype, "cuda")
        before = tfc.LAUNCHES["conv1x3_instnorm_lrelu"]
        got = tfc.conv1x3_instnorm_lrelu(x, w, b)
        want = tfc.conv1x3_instnorm_lrelu_reference(x, w, b)
        torch.cuda.synchronize()
        assert got.shape == shape[:2] + (shape[3],) and got.dtype == dtype
        assert tfc.LAUNCHES["conv1x3_instnorm_lrelu"] - before == 1
        got, want = got.float(), want.float()
        assert bool(torch.isfinite(got).all())
        if dtype == torch.bfloat16:
            assert bool(((got - want).abs() <= 2.0**-7 * want.abs() + 1e-3).all())
        else:
            assert float((got - want).abs().max()) <= 2e-4

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_constant_channels_give_zero_and_unaligned_input_is_copied(self, dtype):
        """A zero batch item and zero weight columns make y constant over T
        (var = 0): the output is 0, not NaN. x starts one element past a
        16-byte boundary, which the wrapper copies for the bf16 kernel."""
        _need_card()
        x, w, b = _conv_inputs((3, 53, 64, 48), torch.float32)
        x[1] = 0.0
        w[:, :, 16:32] = 0.0
        flat = torch.cat([torch.zeros(1), x.reshape(-1)]).to("cuda", dtype)
        x = flat[1:].view(3, 53, 64)
        w, b = w.to("cuda", dtype), b.cuda()
        got = tfc.conv1x3_instnorm_lrelu(x, w, b).float()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert float(got[1].abs().max()) <= 1e-3 and float(got[:, :, 16:32].abs().max()) <= 1e-3
        want = tfc.conv1x3_instnorm_lrelu_reference(x, w, b).float()
        assert bool(((got - want).abs() <= 2.0**-7 * want.abs() + 2e-4).all())
