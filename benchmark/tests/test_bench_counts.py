"""The yardstick's counts: FLOPs, parameters and the kernels' byte bounds."""
import json
import math
import os

import pytest

from benchmark import roofline
from benchmark.reference import nets

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_performancenet_forward_flops_at_batch_16():
    assert roofline.performancenet_forward_flops(config("performancenet"), 16) == 3_169_704_280_064


def test_autoencoder_forward_flops_at_batch_256():
    assert roofline.autoencoder_forward_flops(config("autoencoder"), 256) == 1_298_556_518_400


@pytest.mark.parametrize("name,shapes", [("performancenet", nets.performancenet_shapes),
                                         ("autoencoder", nets.autoencoder_shapes)])
def test_parameter_counts_match_the_configuration(name, shapes):
    cfg = config(name)
    assert sum(math.prod(s) for s in shapes(cfg).values()) == cfg["n_params"]


def test_forward_flops_are_linear_in_batch():
    cfg = config("performancenet")
    assert (roofline.performancenet_forward_flops(cfg, 16)
            == 16 * roofline.performancenet_forward_flops(cfg, 1))


@pytest.mark.parametrize("bound,want_us", [
    (lambda: roofline.k3a_bound_s(5160), 15.8),
    (lambda: roofline.k3b_bound_s(5160), 14.2),
    (lambda: roofline.k2_bound_s(16 * 384 * 860, 2), 6.31),
])
def test_kernel_bounds_give_the_documented_microseconds(bound, want_us):
    got = bound() * 1e6
    assert round(got, 2 if want_us < 10 else 1) == want_us


def test_k2_bound_is_set_by_bytes_at_its_largest_shape():
    n = 16 * 384 * 860
    assert roofline.k2_bound_s(n, 2) == 2 * n * 2 / roofline.HBM_BYTES_PER_S
