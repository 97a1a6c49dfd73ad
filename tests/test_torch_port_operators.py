"""The kernels' ``mmst_torch`` operators, defined and implemented in C++
(``csrc/mmst_ops.cpp``), on the CPU: their CPU implementations against the
Python plain versions and the JAX package's glue, their schemas against the
ones programs exported with the earlier Python operators name, such a
program loaded and run, and the launch counters in the library."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_music_style_transfer_tpu.ops.pallas import gl_glue as jglue
from ml_music_style_transfer_tpu_torch.compat import program_export
from ml_music_style_transfer_tpu_torch.ops import kernels
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.ops.kernels import _library
from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as dk
from ml_music_style_transfer_tpu_torch.ops.kernels import fused_conv as fc
from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue
from ml_music_style_transfer_tpu_torch.ops.kernels import relayout as rl

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the schemas the operators had when they were defined in Python, which
# programs exported then carry
SCHEMAS = {
    "gl_ola_nola": "mmst_torch::gl_ola_nola(Tensor frames, Tensor window, Tensor inv_blocks)"
                   " -> Tensor",
    "gl_frame_window": "mmst_torch::gl_frame_window(Tensor y, Tensor window, SymInt nf)"
                       " -> Tensor",
    "dropout_apply": "mmst_torch::dropout_apply(Tensor x, SymInt seed, SymInt call_index, "
                     "float rate, bool backward=False) -> Tensor",
}
ENTRIES = ["gl_ola_nola", "gl_frame_window", "dropout_mask", "dropout_apply", "dropout_grad",
           "conv1x3_instnorm_lrelu", "relayout"]


def _glue_inputs(nf, seed):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.standard_normal((nf, 2048)).astype(np.float32))
    window = torch.from_numpy(tstft.window_const(2048, 2048))
    inv = torch.from_numpy(tstft.wss_inv_const(2048, 2048, 256, nf)).view(nf + 7, 256)
    return frames, window, inv


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_schema_is_the_python_operators(name):
    assert str(getattr(kernels.ops(), name).default._schema) == SCHEMAS[name]


@pytest.mark.parametrize("nf", [24, 53, 100])
def test_glue_cpu_equals_the_python_plain_versions(nf):
    """The C++ CPU implementations repeat the Python plain versions op for
    op: bit-equal."""
    frames, window, inv = _glue_inputs(nf, nf)
    ops = kernels.ops()
    y = ops.gl_ola_nola(frames, window, inv)
    assert torch.equal(y, gl_glue.ola_nola_reference(frames, window, inv))
    assert torch.equal(ops.gl_frame_window(y, window, nf),
                       gl_glue.frame_window_reference(y, window, nf))


def test_glue_cpu_matches_the_jax_pallas_glue():
    """The two operators in a row against the JAX Pallas glue in interpret
    mode (tests/test_pallas_kernels.py:118-132): 1e-5 (float32 sums of 8
    products in another order)."""
    nf = 64
    frames, window, inv = _glue_inputs(nf, 3)
    want = np.asarray(jglue.gl_consistency_frames(
        jnp.asarray(frames.numpy()), jnp.asarray(window.numpy()), jnp.asarray(inv.numpy()),
        t_tile=32, interpret=True))
    ops = kernels.ops()
    got = ops.gl_frame_window(ops.gl_ola_nola(frames, window, inv), window, nf).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_glue_refuses_what_the_kernels_refuse():
    frames, window, inv = _glue_inputs(30, 0)
    ops = kernels.ops()
    with pytest.raises(RuntimeError, match="float32"):
        ops.gl_ola_nola(frames.double(), window, inv)
    with pytest.raises(RuntimeError, match="at least 24 frames"):
        ops.gl_frame_window(torch.zeros((27, 256)), window, 20)
    with pytest.raises(RuntimeError, match="inv_blocks must have shape"):
        ops.gl_ola_nola(frames, window, inv[:-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("seed", [7, 0x9E3779B97F4A7C15])
def test_dropout_cpu_equals_the_python_plain_version(dtype, seed):
    """Philox bits, keep threshold and scale in C++ against the plain
    versions' PyTorch integer ops: bit-equal, mask and apply, an odd
    element count included."""
    x = torch.randn((3, 5, 7), generator=torch.Generator().manual_seed(1)).to(dtype)
    want = dk.dropout_mask_reference(seed, 11, x.shape, 0.3, dtype)
    assert torch.equal(dk.dropout_mask(seed, 11, x.shape, 0.3, dtype, "cpu"), want)
    assert torch.equal(dk.dropout_apply(x, seed, 11, 0.3),
                       dk.dropout_apply_reference(x, seed, 11, 0.3))
    assert torch.equal(dk.dropout_grad(x, seed, 11, 0.3), x * want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_cpu_equals_the_python_plain_version(dtype):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 70, 13), generator=gen).to(dtype)
    w, b = torch.randn((3, 13, 9), generator=gen), torch.randn((9,), generator=gen)
    got = fc.conv1x3_instnorm_lrelu(x, w, b)
    want = fc.conv1x3_instnorm_lrelu_reference(x, w, b)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_launch_counters_count_cpu_calls_apart_from_cuda_launches():
    """One counter per entry and device, in the library: CPU calls count as
    CPU, ``LAUNCHES`` reads the CUDA counts (none here), a reset clears an
    entry's both."""
    ops = kernels.ops()
    assert list(ops.launch_entries()) == ENTRIES
    for mod in (gl_glue, dk, fc, rl):
        mod.reset_launches()
    frames, window, inv = _glue_inputs(30, 1)
    for _ in range(3):
        gl_glue.gl_consistency_frames(frames, window, inv)
    x = torch.randn(4, 6)
    dk.dropout_apply(x, 1, 0, 0.5)
    dk.dropout_grad(x, 1, 0, 0.5)
    rl.relayout(torch.randn(2, 3, 4), torch.bfloat16, False)
    assert [_library.launch_count(e, "cpu") for e in ENTRIES] == [3, 3, 0, 1, 1, 0, 1]
    assert gl_glue.LAUNCHES == {"gl_ola_nola": 0, "gl_frame_window": 0}
    assert dict(dk.LAUNCHES) == {"dropout_mask": 0, "dropout_apply": 0, "dropout_grad": 0}
    assert dict(rl.LAUNCHES) == {"relayout": 0}
    gl_glue.reset_launches()
    assert _library.launch_count("gl_ola_nola", "cpu") == 0
    assert _library.launch_count("dropout_apply", "cpu") == 1
    with pytest.raises(KeyError):
        gl_glue.LAUNCHES["dropout_apply"]
    with pytest.raises(RuntimeError, match="no launch counter"):
        ops.launch_count("nothing", "cpu")


def test_a_program_exported_with_the_python_operators_still_runs():
    """``griffinlim_python_ops.pt2``: a Griffin-Lim program (32 frames, 2
    iterations) exported while the operators were defined in Python, and
    its output then. Loaded with the C++ operators it gives the same
    output, bit for bit, and runs them."""
    ep = program_export.load_artifact(os.path.join(DATA, "griffinlim_python_ops.pt2"))
    spec = torch.from_numpy(np.random.default_rng(12).random((1025, 32), dtype=np.float32) * 8)
    gl_glue.reset_launches()
    got = ep.module()(spec, program_export.init_phase(spec.shape, 13))
    assert torch.equal(got, torch.load(os.path.join(DATA, "griffinlim_python_ops_out.pt")))
    assert _library.launch_count("gl_ola_nola", "cpu") == 2
