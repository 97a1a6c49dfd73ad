"""The DenseConcat dropout kernel's plain version and wrapper contract (on
the CPU) and the kernel against its plain version (on the card, ``cuda``
marker).

This file imports neither JAX nor the JAX package, so the card's tests run
on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_dropout.py

The kernel and its plain version compute the same Philox4x32-10 bits, so
every kernel-vs-plain comparison here is exact (``torch.equal``).
"""
import numpy as np
import pytest
import torch

from ml_music_style_transfer_tpu_torch.models import layers
from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as dk

# the JAX model's DenseConcat shapes, channel-first (B, C, T), at batch 2:
# hidden 1.5*C and output C at each level, and a ragged size
SHAPES = [(2, 384, 860), (2, 256, 860), (2, 3072, 53), (2, 4096, 53), (3, 5, 7)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")


class TestPhilox:
    def test_random123_known_answers(self):
        """Random123's kat_vectors for philox4x32 with 10 rounds."""
        z = torch.zeros(1, dtype=torch.int64)
        got = [int(w) for w in dk.philox4x32_10((z, z, z, z), (0, 0))]
        assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
        ctr = [torch.tensor([v]) for v in (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)]
        got = [int(w) for w in dk.philox4x32_10(ctr, (0xA4093822, 0x299F31D0))]
        assert got == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]

    def test_mulhilo_has_no_int64_overflow(self):
        rng = np.random.default_rng(0)
        a = np.concatenate([rng.integers(0, 2**32, 2000), [0, 1, 2**32 - 1]])
        for m in dk.PHILOX_M:
            hi, lo = dk._mulhilo(torch.from_numpy(a), m)
            want = [int(x) * m for x in a]
            assert hi.tolist() == [w >> 32 for w in want]
            assert lo.tolist() == [w & 0xFFFFFFFF for w in want]

    def test_bits_depend_on_the_element_not_the_shape(self):
        a = dk.dropout_mask_reference(5, 2, (4, 6, 10), 0.5, torch.float32)
        b = dk.dropout_mask_reference(5, 2, (240,), 0.5, torch.float32)
        c = dk.dropout_mask_reference(5, 2, (237,), 0.5, torch.float32)
        assert torch.equal(a.reshape(-1), b) and torch.equal(b[:237], c)


class TestMask:
    def test_keep_threshold_matches_the_jax_kernel(self):
        """The values tests/test_pallas_kernels.py asserts for _keep_threshold."""
        assert dk.keep_threshold(1.0 - 2.0**-40) == 0
        assert dk.keep_threshold(1.0 - 2.0**-33) == 0
        assert dk.keep_threshold(0.5) == round(0.5 * 2**32) - 1
        assert dk.keep_threshold(0.2) == round(0.8 * 2**32) - 1
        assert dk.keep_threshold(2.0**-40) == 2**32 - 2

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("rate", [0.2, 0.3, 0.5])
    def test_values_are_zero_or_the_scale_in_the_dtype(self, dtype, rate):
        m = dk.dropout_mask(11, 0, (8, 100, 12), rate, dtype, device="cpu")
        scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).to(dtype)
        assert m.dtype == dtype and m.shape == (8, 100, 12)
        assert set(m.unique().tolist()) == {0.0, float(scale)}

    def test_keep_fraction(self):
        """Within 0.01 of 1 - rate at (64, 400, 96), as the JAX kernel's
        statistics test."""
        m = dk.dropout_mask(7, 0, (64, 400, 96), 0.2, torch.float32, device="cpu")
        assert abs(float((m == 0).float().mean()) - 0.2) < 0.01
        assert abs(float(m.mean()) - 1.0) < 0.02

    def test_seed_and_call_index_determinism(self):
        a = dk.dropout_mask(3, 4, (8, 256), 0.5, torch.float32, device="cpu")
        assert torch.equal(a, dk.dropout_mask(3, 4, (8, 256), 0.5, torch.float32, device="cpu"))
        assert not torch.equal(a, dk.dropout_mask(4, 4, (8, 256), 0.5, torch.float32, device="cpu"))
        assert not torch.equal(a, dk.dropout_mask(3, 5, (8, 256), 0.5, torch.float32, device="cpu"))
        # the seed's high word matters too
        assert not torch.equal(
            a, dk.dropout_mask(3 + 2**40, 4, (8, 256), 0.5, torch.float32, device="cpu"))

    def test_extreme_rates_keep_almost_nothing_or_everything(self):
        none = dk.dropout_mask(1, 0, (4096,), 1.0 - 2.0**-40, torch.float32, device="cpu")
        assert not none.any()
        every = dk.dropout_mask(1, 0, (4096,), 2.0**-40, torch.float32, device="cpu")
        assert bool((every == 1.0).all())


class TestWrapperContract:
    def test_cpu_runs_plain_version_and_counts_no_launch(self):
        dk.reset_launches()
        x = torch.randn(4, 6, 10, generator=torch.Generator().manual_seed(0))
        y = dk.dropout_apply(x, 9, 1, 0.2)
        assert torch.equal(y, x * dk.dropout_mask_reference(9, 1, x.shape, 0.2, x.dtype))
        assert dk.LAUNCHES == {"dropout_mask": 0, "dropout_apply": 0, "dropout_grad": 0}

    @pytest.mark.parametrize("bad", ["rate0", "rate1", "seed", "call_index", "dtype",
                                     "contiguous"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        x, seed, ci, rate = torch.ones(4, 6), 1, 0, 0.2
        if bad == "rate0":
            rate = 0.0
        elif bad == "rate1":
            rate = 1.0
        elif bad == "seed":
            seed = 2**64
        elif bad == "call_index":
            ci = -1
        elif bad == "dtype":
            x = x.to(torch.int32)
        else:
            x = torch.ones(6, 4).t()
        with pytest.raises((TypeError, ValueError)):
            dk.dropout_apply(x, seed, ci, rate)


class TestGradient:
    def test_gradcheck_float64(self):
        x = torch.randn(3, 5, 7, dtype=torch.float64, generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        assert torch.autograd.gradcheck(lambda t: dk.dropout(t, 21, 3, 0.4), (x,))

    def test_gradient_is_grad_times_the_same_mask(self):
        gen = torch.Generator().manual_seed(2)
        x = torch.randn(2, 48, 30, generator=gen, requires_grad=True)
        g = torch.randn(2, 48, 30, generator=gen)
        dk.dropout(x, 77, 6, 0.2).backward(g)
        assert torch.equal(x.grad, g * dk.dropout_mask_reference(77, 6, x.shape, 0.2, x.dtype))


class TestDenseConcat:
    def _block(self, dtype="float32"):
        torch.manual_seed(0)
        blk = layers.DenseConcat(48 + 32, 48, 32, 0.2, dtype)
        for p in blk.parameters():
            torch.nn.init.normal_(p, std=0.2)
        gen = torch.Generator().manual_seed(3)
        return blk, torch.randn(2, 32, 20, generator=gen), torch.randn(2, 48, 20, generator=gen)

    def test_train_mode_equals_the_explicit_chain(self):
        blk, midi, audio = self._block()
        seed, ci = 1234567890123, 4
        got = blk(midi, audio, deterministic=False, dropout_seed=seed, call_index=ci)
        x = torch.relu(blk.fc1(torch.cat([audio, midi], dim=1)))
        x = x * dk.dropout_mask_reference(seed, ci, x.shape, 0.2, x.dtype)
        x = torch.relu(blk.fc2(x))
        want = x * dk.dropout_mask_reference(seed, ci + 1, x.shape, 0.2, x.dtype)
        assert torch.equal(got, want)
        assert torch.equal(blk(midi, audio), torch.relu(blk.fc2(torch.relu(
            blk.fc1(torch.cat([audio, midi], dim=1))))))

    def test_train_mode_without_a_seed_raises(self):
        blk, midi, audio = self._block()
        with pytest.raises(ValueError, match="dropout_seed"):
            blk(midi, audio, deterministic=False)


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_mask_and_apply_bit_equal_to_plain(self, dtype, shape):
        _need_card()
        seed, ci, rate = 0x0123456789ABCDEF, 7, 0.2
        x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to("cuda", dtype)
        before = dict(dk.LAUNCHES)
        m = dk.dropout_mask(seed, ci, shape, rate, dtype)
        y = dk.dropout_apply(x, seed, ci, rate)
        torch.cuda.synchronize()
        assert torch.equal(m, dk.dropout_mask_reference(seed, ci, shape, rate, dtype, "cuda"))
        assert torch.equal(y, dk.dropout_apply_reference(x, seed, ci, rate))
        assert dk.LAUNCHES["dropout_mask"] - before["dropout_mask"] == 1
        assert dk.LAUNCHES["dropout_apply"] - before["dropout_apply"] == 1

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_unaligned_input_takes_the_scalar_path(self, dtype):
        _need_card()
        x = torch.randn(1 + 8 * 1000 + 5, generator=torch.Generator().manual_seed(1))
        x = x.to("cuda", dtype)[1:]  # contiguous, one element past a 16-byte boundary
        y = dk.dropout_apply(x, 5, 0, 0.3)
        torch.cuda.synchronize()
        assert torch.equal(y, dk.dropout_apply_reference(x, 5, 0, 0.3))

    def test_backward_launches_the_kernel_and_equals_grad_times_mask(self):
        _need_card()
        gen = torch.Generator().manual_seed(2)
        x = torch.randn(2, 384, 860, generator=gen).to("cuda", torch.bfloat16).requires_grad_()
        g = torch.randn(2, 384, 860, generator=gen).to("cuda", torch.bfloat16)
        before = dk.LAUNCHES["dropout_grad"]
        dk.dropout(x, 99, 3, 0.2).backward(g)
        torch.cuda.synchronize()
        assert dk.LAUNCHES["dropout_grad"] - before == 1
        assert torch.equal(x.grad, g * dk.dropout_mask_reference(99, 3, x.shape, 0.2,
                                                                 x.dtype, "cuda"))
