"""The float32 gradients of the port's model differ from the float64 ones
only by branch flips (``tests/torch_port_kinks.py``): with the float64
forward's LeakyReLU, MaxPool and L1 branches imposed, the float32 gradients
meet the JAX time-sharded test's gradient tolerance (relative L2 < 1e-3,
tests/test_time_shard.py:310-311) at every clip length; on their own
branches they miss it only where a branch flipped. Width 1/16, the
time-sharded tests' model and clips; the JAX package's float32 gradients
read the same (printed by ``python tests/torch_port_kinks.py``).
"""
import pytest
import torch

import torch_port_kinks as K

GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def state():
    return K.model_state()


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("t_valid", [300, 480, 860])
def test_gradient_gaps_are_branch_flips(t_valid, state):
    r = K.readings(state, K.clip_inputs(t_valid))
    assert r["f32_on_f64_branches"] < GRAD_TOL, r["f32_on_f64_branches"]
    assert r["f32"] < GRAD_TOL or r["n_flips"] >= 1, (r["f32"], r["flips"])
