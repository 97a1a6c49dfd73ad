"""The kernels on the multi-device paths against their plain versions (on
the card, ``cuda`` marker; they skip here): the Philox dropout kernel
under the mesh's seed folding, and the Griffin-Lim glue kernels inside
sharded Griffin-Lim.

This file imports neither JAX nor the JAX package, so the card's tests run
on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_parallel_kernels.py

The CPU side of the same paths (gloo ranks, against the JAX package) is in
test_torch_port_parallel.py and test_torch_port_gl_shard.py.
"""
import numpy as np
import pytest
import torch

from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as dk
from ml_music_style_transfer_tpu_torch.ops.kernels import gl_glue as glue
from ml_music_style_transfer_tpu_torch.parallel import gl_shard


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")


# DenseConcat's hidden and output shapes at width 1 (channel-first), batch 4
# per data rank, and a model axis of 2 (the hidden slice of one rank)
HIDDEN, OUT = (4, 3072 // 2, 53), (4, 4096, 53)


@pytest.mark.cuda
def test_dropout_masks_by_mesh_rank_kernel_vs_plain():
    """On a (2 data, 2 model) mesh, DenseConcat's first mask (fc1's
    column-parallel output) folds both ranks into the seed, its second
    (fc2's whole output) the data rank only: kernel masks equal the plain
    ones bit for bit, differ across data ranks, and the second agrees
    across model ranks."""
    _need_card()
    seed, rate = 0x1234_5678_9ABC_DEF0, 0.2
    first, second = {}, {}
    for d in (0, 1):
        sd = dk.fold_seed(seed, d)
        for m in (0, 1):
            s1 = dk.fold_seed(sd, m)
            first[d, m] = dk.dropout_mask(s1, 0, HIDDEN, rate, torch.bfloat16, "cuda")
            second[d, m] = dk.dropout_mask(sd, 1, OUT, rate, torch.bfloat16, "cuda")
            torch.cuda.synchronize()
            assert torch.equal(first[d, m], dk.dropout_mask_reference(
                s1, 0, HIDDEN, rate, torch.bfloat16, "cuda"))
            assert torch.equal(second[d, m], dk.dropout_mask_reference(
                sd, 1, OUT, rate, torch.bfloat16, "cuda"))
    assert torch.equal(first[0, 0], dk.dropout_mask(seed, 0, HIDDEN, rate, torch.bfloat16,
                                                    "cuda"))  # rank 0 draws one device's mask
    for m in (0, 1):
        assert not torch.equal(first[0, m], first[1, m])
        assert not torch.equal(second[0, m], second[1, m])
    for d in (0, 1):
        assert torch.equal(second[d, 0], second[d, 1])
        assert not torch.equal(first[d, 0], first[d, 1])


@pytest.mark.cuda
def test_sharded_griffinlim_launches_the_glue_and_equals_griffinlim():
    """One rank's sharded Griffin-Lim is ``griffinlim`` from the same
    field: n_iter launches of each glue kernel, the same bits; and through
    the kernels within 1e-3 of the peak of the plain istft/stft path."""
    _need_card()
    rng = np.random.default_rng(0)
    spec = torch.from_numpy((rng.random((860, 1025)) * 6.0).astype(np.float32)).cuda()
    glue.reset_launches()
    got = gl_shard.sharded_griffinlim_from_log_power(spec, None, n_iter=20, seed=2)
    torch.cuda.synchronize()
    assert dict(glue.LAUNCHES) == {"gl_ola_nola": 20, "gl_frame_window": 20}
    field = gl_shard.phase_field(1025, 860, seed=2)
    mag = torch.sqrt(torch.expm1(torch.clamp(spec.transpose(0, 1).contiguous(), 0.0, 20.0)))
    want = tgl.griffinlim(mag, n_iter=20, init_phase=field, device="cuda")
    plain = tgl.griffinlim(mag, n_iter=20, init_phase=field, use_pallas_glue=False,
                           device="cuda")
    assert torch.equal(got[:want.shape[0]], want)
    assert float((want - plain).abs().max()) <= 1e-3 * float(plain.abs().max())
