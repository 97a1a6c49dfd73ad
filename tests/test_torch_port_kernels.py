"""The Griffin-Lim glue, fused-conv and relayout kernels' wrapper contracts
(on the CPU) and the kernels against their plain PyTorch versions (on the
card, ``cuda`` marker).

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
from ml_music_style_transfer_tpu_torch.ops.kernels import relayout as trelayout

N_FFT, HOP = 2048, 256
# (B, T, Cin, Cout): the JAX test's shape (T = 64, one box exactly full; its
# first CTA holds items 0 and 1); Cin = 1025 (audio_down_0.conv1's unaligned
# rows) at T = 53; Cin and Cout off the 8-element bf16 alignment; everything
# ragged and smaller than a tile; T = 65 (one row over a box); three boxes an
# item, so the second CTA holds item 0's ragged last box and item 1's first;
# Cout = 64 (the narrow N tile) with Cin = 1025; 264 boxes by 512 channels
# and 16 items of T = 53 by 6144 channels, grids for which a 132-SM card
# picks the 256- and the 192-wide tile (the small shapes take the 128-wide)
CONV_SHAPES = [(3, 64, 96, 160), (2, 53, 1025, 136), (5, 40, 130, 72), (2, 7, 5, 3),
               (3, 65, 64, 192), (2, 130, 128, 96), (2, 107, 1025, 64), (2, 8448, 64, 512),
               (16, 53, 64, 6144)]


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


class TestBoxedStatistics:
    """``instnorm_stats_boxed`` (the kernel's reduction: 64-row box partials,
    then Chan's merge) against ``torch.var_mean`` over T, with a channel
    whose |mean| is 1e4 times its std and a constant channel."""

    @staticmethod
    def _y(T, dtype):
        rng = np.random.default_rng(T)
        y = rng.standard_normal((2, T, 5))
        y[:, :, 1] = 1e4 + y[:, :, 1]  # |mean| = 1e4 std
        y[:, :, 2] = 0.75  # constant: var 0
        y[:, :, 3] *= 1e-3
        return torch.from_numpy(y).to(dtype)

    @pytest.mark.parametrize("T", [1, 53, 64, 65, 107, 860])
    def test_float64_matches_var_mean(self, T):
        """1e-6 relative (of |mean| + std for the mean, of var for var)."""
        y = self._y(T, torch.float64)
        mean, var = tfc.instnorm_stats_boxed(y)
        var_ref, mean_ref = torch.var_mean(y, dim=1, correction=0)
        scale = mean_ref.abs() + var_ref.sqrt()
        assert bool(((mean - mean_ref).abs() <= 1e-6 * scale).all())
        assert bool(((var - var_ref).abs() <= 1e-6 * var_ref + 1e-300).all())
        assert bool((var[:, 2] == 0).all())

    @pytest.mark.parametrize("T", [1, 53, 64, 65, 107, 860])
    def test_float32_as_close_as_the_two_pass_reference(self, T):
        """In float32, against the float64 statistics of the same values:
        the boxed merge stays within the tolerance that the two-pass
        statistics of ``conv1x3_instnorm_lrelu_reference`` meet (mean 1e-6
        of |mean| + std, var 1e-4 relative), and the constant channel's
        variance is exactly 0."""
        y = self._y(T, torch.float32)
        var_ref, mean_ref = torch.var_mean(y.double(), dim=1, correction=0)
        scale = mean_ref.abs() + var_ref.sqrt()
        two_mean = y.mean(dim=1, keepdim=True)
        two_var = ((y - two_mean) ** 2).mean(dim=1)
        for mean, var in (tfc.instnorm_stats_boxed(y), (two_mean[:, 0], two_var)):
            assert bool(((mean.double() - mean_ref).abs() <= 1e-6 * scale).all())
            assert bool(((var.double() - var_ref).abs() <= 1e-4 * var_ref + 1e-30).all())
        assert bool((tfc.instnorm_stats_boxed(y)[1][:, 2] == 0).all())


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

    def test_large_channel_offset_merges_without_cancellation(self):
        """x + 50: every channel of y carries a large offset against its
        spread over T, which a sum / sum-of-squares variance would cancel;
        T = 860 merges 14 boxes. Same bf16 tolerance as above."""
        _need_card()
        x, w, b = _conv_inputs((2, 860, 256, 192), torch.float32, seed=4)
        x, w, b = (x + 50.0).to("cuda", torch.bfloat16), w.to("cuda", torch.bfloat16), b.cuda()
        got = tfc.conv1x3_instnorm_lrelu(x, w, b).float()
        want = tfc.conv1x3_instnorm_lrelu_reference(x, w, b).float()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= 2.0**-7 * want.abs() + 1e-3).all())

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


# (B, C, T) of the relayout kernel K4: ragged tiles, one channel band of a
# wider tensor (the MBR blocks' slices), and the widest training shapes
RELAYOUT_SHAPES = [(2, 5, 7), (3, 33, 65), (1, 1025, 860), (4, 1536, 53), (2, 64, 860)]


def _relayout_input(shape, dtype, first_in, device, band=False):
    """A (B, C, T) tensor stored channel-last (``first_in`` False) or
    channel-first; with ``band``, channels 3.. of a wider tensor."""
    b, c, t = shape
    extra = 3 if band else 0
    g = torch.Generator().manual_seed(c * t)
    x = torch.randn(b, c + extra, t, generator=g).to(dtype)
    if not first_in:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    return x.to(device)[:, extra:]


class TestRelayout:
    @pytest.mark.parametrize("first", [True, False])
    def test_cpu_values_and_layout(self, first):
        x = _relayout_input((2, 6, 9), torch.bfloat16, first_in=first, device="cpu")
        y = trelayout.relayout(x, torch.float32, not first)
        assert y.dtype == torch.float32 and torch.equal(y, x.float())
        assert (y.is_contiguous() if not first else y.transpose(1, 2).is_contiguous())

    @pytest.mark.cuda
    @pytest.mark.parametrize("shape", RELAYOUT_SHAPES)
    @pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32),
                                        (torch.float32, torch.bfloat16),
                                        (torch.bfloat16, torch.bfloat16)])
    @pytest.mark.parametrize("first", [True, False])
    def test_kernel_equals_the_plain_cast(self, shape, dtypes, first):
        """Bit for bit: each value cast once, to nearest even, into the
        other layout; a band of a wider tensor read through its strides."""
        _need_card()
        src, dst = dtypes
        for band in (False, True):
            x = _relayout_input(shape, src, first_in=not first, device="cuda", band=band)
            y = trelayout.relayout(x, dst, first)
            want = x.to(dst)
            assert torch.equal(y, want), (shape, dtypes, first, band)
            assert (y.is_contiguous() if first else y.transpose(1, 2).is_contiguous())

    @pytest.mark.cuda
    @pytest.mark.parametrize("first", [True, False])
    def test_kernel_launches_or_raises(self, first):
        """On the card the operator launches K4 for every input of its
        dtypes, one already stored as asked too (read through its strides),
        and raises for any other dtype: no plain fallback."""
        _need_card()
        trelayout.reset_launches()
        x = _relayout_input((2, 70, 90), torch.bfloat16, first_in=first, device="cuda")
        y = trelayout.relayout(x, torch.float32, first)
        assert torch.equal(y, x.float()) and trelayout.LAUNCHES["relayout"] == 1
        for src, dst in ((torch.float64, torch.float32), (torch.float32, torch.float64)):
            with pytest.raises(RuntimeError, match="float32 or bfloat16"):
                trelayout.relayout(x.to(src), dst, first)
        assert trelayout.LAUNCHES["relayout"] == 1
