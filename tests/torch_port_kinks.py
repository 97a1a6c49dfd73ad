"""Why this model's float32 gradients can move by percents: branch flips.

The model's output passes through piecewise-linear ops: LeakyReLU (after
every InstanceNorm and at the end), MaxPool(2) in the encoders, and the L1
loss. Its gradient is discontinuous where an input of one of them sits at
its kink (0 for LeakyReLU and L1, a tie for the max). A float32 forward
rounds each activation by about 1e-6 of its size; an element that lies
closer than that to a kink can take the other branch than the float64
forward does, and the L1 gradient, a sum of one +-1/N term per output
element with mostly cancelling signs, then moves by O(1/sqrt(N)) of its
size: percents at width 1/16.

``run`` records every such op's branch (LeakyReLU's sign mask, MaxPool's
argmax, L1's sign) and can replay another run's branches, so a float32
gradient can be computed on the float64 forward's branches. The time-
sharded gradient test (tests/test_torch_port_time_shard.py) holds its clip
to no flip; tests/test_torch_port_gradient_kinks.py shows the flips are
the whole gap. Run this file to print the readings, the JAX package's
float32 gradients beside the port's::

    python tests/torch_port_kinks.py
"""
import numpy as np
import torch
import torch.nn.functional as F

from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.models import PerformanceNet
from ml_music_style_transfer_tpu_torch.models import layers, performance_net
from ml_music_style_transfer_tpu_torch.parallel import time_shard as ts

TS_KW = dict(start_channels=32, start_audio_channels=65, width_mult=1 / 16)


def model_state() -> dict:
    """The time-sharded tests' weights (seeded port init), as numpy."""
    gen = torch.Generator().manual_seed(3)
    return {k: v.numpy() for k, v in PerformanceNet(
        ModelConfig(**TS_KW, compute_dtype="float32"), generator=gen).state_dict().items()}


def clip_inputs(t_valid: int, seed: int = 21) -> dict:
    """One clip of ``t_valid`` frames (midi and cond noise, 5 % onsets)
    and an L1 target over the net's output frames."""
    rng = np.random.default_rng(seed)
    t_out = ts.time_sharded_output_length(t_valid)
    return {"xm": rng.standard_normal((1, t_valid, 32)).astype(np.float32),
            "xa": rng.standard_normal((1, t_valid, 65)).astype(np.float32),
            "xc": (rng.random((1, t_valid, 32)) < 0.05).astype(np.float32),
            "target": rng.standard_normal((1, t_out, 65)).astype(np.float32)}


class _Branches:
    """LeakyReLU and MaxPool that record their branches, or take the
    branches of an earlier run in call order."""

    def __init__(self, replay=None):
        self.rec, self.replay = [], replay

    def _branch(self, own):
        return own() if self.replay is None else self.replay[len(self.rec)][1]

    def leaky_relu(self, x, slope=0.01):
        pos = self._branch(lambda: x > 0)
        self.rec.append(("leaky_relu", pos, x.detach().double()))
        return torch.where(pos, x, x * slope)

    def max_pool1d(self, x, kernel_size, stride):
        idx = self._branch(lambda: F.max_pool1d_with_indices(x, kernel_size, stride)[1])
        self.rec.append(("max_pool1d", idx, x.detach().double()))
        return torch.gather(x, -1, idx)


def run(state: dict, inputs: dict, dtype: torch.dtype, replay=None):
    """Mean L1 loss of the unsharded model in ``dtype`` and its gradients.
    Returns (branches, {name: float64 gradient}); ``replay``: the branches
    of another run to take instead of this one's."""
    br = _Branches(replay)
    saved = layers.leaky_relu, performance_net.leaky_relu, F.max_pool1d
    layers.leaky_relu = performance_net.leaky_relu = br.leaky_relu
    F.max_pool1d = br.max_pool1d
    try:
        model = PerformanceNet(ModelConfig(**TS_KW, compute_dtype=str(dtype).split(".")[1]),
                               device="meta")
        model.load_state_dict({k: torch.from_numpy(v).to(dtype) for k, v in state.items()},
                              assign=True)
        pred = model(*(torch.from_numpy(inputs[k]).to(dtype) for k in ("xm", "xa", "xc")))
    finally:
        layers.leaky_relu, performance_net.leaky_relu, F.max_pool1d = saved
    diff = pred - torch.from_numpy(inputs["target"]).to(dtype)
    sign = torch.sign(diff.detach()) if replay is None else replay[-1][1].to(dtype)
    br.rec.append(("l1", sign, diff.detach().double()))
    (torch.sum(sign * diff) / diff.numel()).backward()  # = mean |diff| on these branches
    return br.rec, {n: p.grad.double() for n, p in model.named_parameters()}


def rel_l2(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradient dicts, taken as one vector."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def readings(state: dict, inputs: dict) -> dict:
    """Branch flips of the float32 forward against the float64 one, and the
    float32 gradients' relative L2 from the float64 ones, on their own
    branches and on float64's; the float64 gradients."""
    b64, g64 = run(state, inputs, torch.float64)
    b32, g32 = run(state, inputs, torch.float32)
    _, pinned = run(state, inputs, torch.float32, replay=b64)
    flips = {}
    for (kind, a, _), (_, b, _) in zip(b64, b32):
        flips[kind] = flips.get(kind, 0) + int((a != b).sum())
    return {"flips": flips, "n_flips": sum(flips.values()), "f32": rel_l2(g32, g64),
            "f32_on_f64_branches": rel_l2(pinned, g64), "g64": g64}


def main() -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
    from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
    from ml_music_style_transfer_tpu_torch.compat import weights

    state = model_state()
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), weights.to_jax_params(
        {k: torch.from_numpy(v) for k, v in state.items()}))
    jmodel = JPerformanceNet(JModelConfig(**TS_KW, compute_dtype="float32"))
    for t in (300, 480, 860):
        inputs = clip_inputs(t)
        r = readings(state, inputs)
        x = [jnp.asarray(inputs[k]) for k in ("xm", "xa", "xc")]
        grads = jax.grad(lambda p: jnp.mean(jnp.abs(jmodel.apply(p, *x) - inputs["target"])))(
            params)
        jg = {k: v.double() for k, v in weights.from_jax_params(
            jax.tree_util.tree_map(np.asarray, grads)).items()}
        print(f"T={t}: float32 branch flips {r['flips']}; relative L2 from the float64 "
              f"gradients: port float32 {r['f32']:.3e}, port float32 on float64's branches "
              f"{r['f32_on_f64_branches']:.3e}, JAX float32 {rel_l2(jg, r['g64']):.3e}")


if __name__ == "__main__":
    main()
