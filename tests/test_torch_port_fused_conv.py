"""The fused Conv1x3 -> InstanceNorm -> LeakyReLU port (K1) against the JAX
package on the CPU: the plain version and the wrapper on CPU tensors against
the Pallas kernel (interpret mode) and its unfused reference, the plain
version against the port's own model blocks, and ``model_layer_shapes``
against the shapes a forward of the port's model really runs. Inputs come
from numpy seeds; tolerances are stated per test."""
import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax.numpy as jnp

from ml_music_style_transfer_tpu.ops.pallas import fused_conv as jfc
from ml_music_style_transfer_tpu_torch.compat import from_jax_params
from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.models import PerformanceNet, layers
from ml_music_style_transfer_tpu_torch.ops.kernels import fused_conv as fc
from ml_music_style_transfer_tpu_torch.scripts import bench_fused_conv

ATOL = 2e-4  # the JAX kernel test's tolerance, float32
CASES = {  # (B, T, Cin, Cout, which input block is zero)
    "jax_test_shape": (3, 64, 96, 160, None),
    "unaligned": (5, 40, 130, 72, None),
    # a zero batch item and zero weight columns: y is the bias over T, var 0
    "zero_block": (3, 32, 48, 40, "zero"),
}


def _data(B, T, cin, cout, zero=None, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cin)).astype(dtype)
    w = (rng.standard_normal((3, cin, cout)) / np.sqrt(3 * cin)).astype(dtype)
    b = rng.standard_normal(cout).astype(dtype)
    if zero:
        x[1] = 0.0
        w[:, :, 8:24] = 0.0
    return x, w, b


@functools.cache
def _jax_results(case):
    x, w, b = _data(*CASES[case])
    xj, wj, bj = map(jnp.asarray, (x, w, b))
    return (np.asarray(jfc.conv1x3_instnorm_lrelu(xj, wj, bj, interpret=True)),
            np.asarray(jfc.conv1x3_instnorm_lrelu_reference(xj, wj, bj)))


class TestAgainstJax:
    @pytest.mark.parametrize("port_fn", ["reference", "wrapper"])
    @pytest.mark.parametrize("case", list(CASES))
    def test_matches_pallas_kernel_and_reference(self, case, port_fn):
        x, w, b = map(torch.from_numpy, _data(*CASES[case]))
        fn = (fc.conv1x3_instnorm_lrelu_reference if port_fn == "reference"
              else fc.conv1x3_instnorm_lrelu)
        got = fn(x, w, b).numpy()
        kernel, ref = _jax_results(case)
        B, T, _, cout, zero = CASES[case]
        assert got.shape == (B, T, cout) and got.dtype == np.float32
        np.testing.assert_allclose(got, kernel, atol=ATOL)
        np.testing.assert_allclose(got, ref, atol=ATOL)
        if zero:  # var = 0 gives 0, not NaN
            assert np.abs(got[1]).max() <= ATOL and np.abs(got[:, :, 8:24]).max() <= ATOL

    def test_bf16_inputs_match_jax_reference(self):
        """w is cast to x's dtype and the bias taken in float32, as the JAX
        wrapper does; the products are exact, so the two differ by at most
        one bf16 rounding of the output (2^-7 relative) plus 1e-3."""
        x, w, b = _data(2, 40, 64, 48, seed=3)
        xb = torch.from_numpy(x).bfloat16()
        got = fc.conv1x3_instnorm_lrelu(xb, torch.from_numpy(w), torch.from_numpy(b))
        assert got.dtype == torch.bfloat16
        want = np.asarray(jfc.conv1x3_instnorm_lrelu_reference(
            jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(b)).astype(jnp.float32))
        got = got.float().numpy()
        assert (np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-3).all()


def test_matches_model_layer_semantics():
    """The plain version == the port's Conv1x3 + instance_norm + leaky_relu
    with the same JAX weights carried across by ``from_jax_params`` (the JAX
    test_pallas_kernels.py:34-44 case), float32, atol 2e-4."""
    x, w, b = _data(2, 50, 64, 64, seed=2)
    state = from_jax_params({"params": {"midi_down_0": {"Conv1x3_0": {"Conv_0": {
        "kernel": w, "bias": b}}}}})
    conv = layers.Conv1x3(64, 64, "float32")
    conv.load_state_dict({k.rsplit(".", 1)[1]: v for k, v in state.items()})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        want = layers.leaky_relu(layers.instance_norm(conv(xt.transpose(1, 2)))).transpose(1, 2)
    got = fc.conv1x3_instnorm_lrelu_reference(xt, torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


class _ConvLog(TorchFunctionMode):
    """Records the convolutions and LeakyReLUs a forward calls, in order."""

    def __init__(self):
        super().__init__()
        self.events = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.nn.functional.conv1d:
            x, w = args[0], args[1]
            self.events.append(("conv", (x.shape[0], x.shape[2], w.shape[1], w.shape[0])))
        elif func in (torch.nn.functional.conv_transpose1d, torch.nn.functional.leaky_relu):
            self.events.append((func.__name__, None))
        return func(*args, **(kwargs or {}))


def _blocks_seen(cfg, batch):
    """(B, T, Cin, Cout) of every conv1d whose next conv or activation call
    is a LeakyReLU, in a forward of the port's model (on the meta device)."""
    model = PerformanceNet(cfg, device="meta")
    inputs = [torch.empty((batch, 860, c), device="meta") for c in (128, 1025, 128)]
    log = _ConvLog()
    with torch.no_grad(), log:
        model(*inputs)
    ev = log.events
    return [shape for (kind, shape), (nxt, _) in zip(ev, ev[1:])
            if kind == "conv" and nxt == "leaky_relu"]


class TestModelLayerShapes:
    @pytest.mark.parametrize("compat", [False, True])
    def test_equals_the_blocks_a_forward_runs(self, compat):
        cfg = ModelConfig(width_mult=1 / 16, compat_mbr_noop=compat)
        want = [blk.shape for blk in fc.model_layer_shapes(cfg, 16) for _ in range(blk.launches)]
        assert _blocks_seen(cfg, 16) == want
        assert len(want) == (34 if compat else 64)

    def test_full_width_count(self):
        """38 blocks, 64 launches (an MBR conv_list1 per band), 31 distinct
        shapes, 2.49 TFLOP at batch 16; the largest are audio_down_0.conv2
        and audio_down_4.conv2."""
        blocks = fc.model_layer_shapes(ModelConfig(), 16)
        assert len(blocks) == 38 and sum(b.launches for b in blocks) == 64
        assert len({b.shape for b in blocks}) == 31
        flops = {b.name: 6 * b.batch * b.t * b.cin * b.cout for b in blocks}
        assert sum(flops[b.name] * b.launches for b in blocks) == 2_493_103_669_248
        assert flops["down_convs_audio.0.conv2"] == 194_783_477_760
        assert flops["down_convs_audio.4.conv2"] == 192_065_568_768
        by_name = {b.name: b for b in blocks}
        assert by_name["down_convs_audio.0.conv1"].shape == (16, 860, 1025, 1536)
        assert by_name["MBRBlock4.conv_list1"].shape == (16, 860, 64, 64)
        assert by_name["MBRBlock4.conv_list1"].launches == 16


class TestContract:
    """Without a card. The wrapper's argument checks (dtype, shapes,
    device, inputs that require grad) are in test_torch_port_kernels.py,
    which imports no JAX."""

    def test_kernel_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        """A CUDA tensor goes to the kernel library, never to the plain
        version: building the operator library with its CUDA kernels (as
        a PyTorch built for CUDA does) raises without nvcc (this machine
        has none)."""
        from ml_music_style_transfer_tpu_torch.ops.kernels import _build

        if _build.shutil.which("nvcc") or torch.cuda.is_available():
            pytest.skip("this machine can build the kernels")
        monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
        monkeypatch.setattr(_build, "with_cuda", lambda: True)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build_all()

    def test_bench_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            bench_fused_conv.main([])

    def test_bench_bound_and_shapes(self):
        """The bench's four shapes are bench_pallas.py's; the bound of
        audio_down_0.conv2 in bf16 is its FLOPs at 989 TFLOP/s plus the
        normalisation's at 67 TFLOP/s (197 us): operations, not bytes."""
        assert [s[:4] for s in bench_fused_conv.SHAPES] == [
            (16, 860, 1025, 1536), (16, 430, 1536, 2048), (16, 53, 4096, 6144),
            (16, 860, 128, 256)]
        ms, by = bench_fused_conv.bound_ms(16, 860, 1536, 1536, torch.bfloat16)
        assert by == "operations"
        assert ms == pytest.approx((194_783_477_760 / 989e12 + 8 * 16 * 860 * 1536 / 67e12) * 1e3)
        assert bench_fused_conv.bound_ms(16, 860, 64, 64, torch.bfloat16)[1] == "bytes"
        line = bench_fused_conv.row_line("audio L0", dict(
            ms=0.5, plain_ms=4.0, library_ms=0.7, max_abs_err=0.01, bound_ms=0.134,
            bound_by="operations", ctas=672))
        assert "cuDNN/kernel 1.40x" in line and "| 672 CTAs |" in line
