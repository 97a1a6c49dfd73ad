"""The port's mesh layer (``parallel/mesh.py``, DP/TP/ZeRO-1 training, the
resident store on a mesh) against the JAX package's ``parallel/mesh.py``
and mesh ``Trainer``, on the CPU.

The JAX side runs on its virtual 8-device CPU mesh (tests/conftest.py); the
port runs on gloo ranks (``parallel/launch.spawn``, one spawn of 4 ranks
for all the mesh runs). Both train the same width-1/16 float32 weights
(the port's seeded init, crossed to flax by ``compat/weights``) on the same
numpy batch, with dropout off (the JAX Trainer draws threefry masks).
Tolerances are the JAX tests': the first loss within 1e-4 relative and the
loss after one step within 1e-3 (tests/test_parallel.py:97-98). ZeRO-1 is
held to the same mesh's unsharded step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_port_parallel_workers as W
from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.config import TrainConfig as JTrainConfig
from ml_music_style_transfer_tpu.parallel import mesh as jmesh
from ml_music_style_transfer_tpu.train.loop import Trainer as JTrainer
from ml_music_style_transfer_tpu_torch.compat import weights
from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.models import PerformanceNet
from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as dk
from ml_music_style_transfer_tpu_torch.parallel import launch
from ml_music_style_transfer_tpu_torch.parallel import mesh as pmesh

B, T = 4, 220  # a valid decoder ladder; 4 rows split over every mesh below

# (name, (data, model, dcn), TrainConfig options), all on 4 ranks
OPTIONS = dict(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16", grad_clip_norm=0.5,
               warmup_steps=2, ema_decay=0.9)
RUNS = [
    ("dp", (4, 1, 1), {}),
    ("dp_tp", (2, 2, 1), {}),
    ("hybrid", (1, 2, 2), {}),
    ("zero", (4, 1, 1), {"zero_opt": True}),
    ("zero_tp", (2, 2, 1), {"zero_opt": True}),
    ("dp_options", (4, 1, 1), OPTIONS),
    ("zero_options", (4, 1, 1), dict(OPTIONS, zero_opt=True)),
    ("dp_accum", (2, 2, 1), {"grad_accum": 2}),
    ("zero_accum", (2, 2, 1), {"grad_accum": 2, "zero_opt": True}),
]
MATCH_JAX = ["dp", "dp_tp", "hybrid", "zero", "zero_tp"]


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "midi": (rng.random((B, T, 128)) < 0.05).astype(np.float32),
        "onoff": rng.choice([-1, 0, 1], (B, T, 128), p=[0.02, 0.96, 0.02]).astype(np.float32),
        "cond": rng.random((B, T, 1025)).astype(np.float32),
        "target": rng.random((B, T, 1025)).astype(np.float32),
        "weight": np.ones((B,), np.float32),
    }


def _port_init_state():
    """The weights every port Trainer starts from (``init_state(0)``)."""
    gen = torch.Generator().manual_seed(0)
    return PerformanceNet(ModelConfig(**W.TINY_KW), generator=gen).state_dict()


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX Trainer on a (2, 2) mesh of 4 virtual devices: two steps
    from the port's initial weights."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh (tests/conftest.py)")
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    tr = JTrainer(JModelConfig(**W.TINY_KW), JTrainConfig(batch_size=B), mesh=mesh)
    tree = weights.to_jax_params(_port_init_state())
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    params = jmesh.shard_params(params, mesh)
    opt_state = jax.jit(tr.tx.init)(params)
    batch = jax.device_put(_batch(), tr._batch_sharding)
    losses = []
    for s in range(2):
        params, opt_state, loss = tr.train_step(params, opt_state, batch, jax.random.PRNGKey(s))
        losses.append(float(loss))
    return {"losses": losses}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = launch.spawn(W.mesh_training, 4, (_batch(), RUNS, str(tmp_path_factory.mktemp("ck"))),
                       device="cpu")
    return out


# ---- the rules, against the JAX package's ---------------------------------------

def _flax_dim(rule_kind: str, torch_dim: int | None, ndim: int) -> int | None:
    """A torch-layout dim of a weight as the flax kernel's dim."""
    if torch_dim is None:
        return None
    if ndim == 1:
        return 0
    to_flax = {"conv": (2, 1, 0), "convT": (1, 2, 0), "lin": (1, 0)}[rule_kind]
    return to_flax[torch_dim]


@pytest.mark.parametrize("model_size", [2, 4, 8])
def test_param_shard_dim_matches_jax_param_pspec(model_size):
    """Every parameter of the width-1/16 model: the port's rule on its
    state_dict key and torch shape names the dim that the JAX rule shards
    on the flax path and shape (through the weights' key map)."""
    import re

    model = PerformanceNet(ModelConfig(width_mult=1 / 16), device="meta")
    n_sharded = 0
    for name, p in model.named_parameters():
        module, leaf = name.rsplit(".", 1)
        for _, _, trx, flax_fn, kind in weights.PERFORMANCE_NET:
            m = re.match(trx, module)
            if m:
                break
        else:
            raise AssertionError(f"no key rule for {name}")
        flax_leaf = "kernel" if leaf == "weight" else "bias"
        flax_shape = tuple(weights._TO_FLAX[kind](torch.empty(p.shape, device="meta")).shape
                           if leaf == "weight" else p.shape)
        spec = jmesh.param_pspec(f"{flax_fn(m)}/{flax_leaf}", np.zeros(flax_shape, np.int8),
                                 model_size)
        want = next((i for i, e in enumerate(spec) if e == "model"), None)
        got = pmesh.param_shard_dim(name, p.shape, model_size)
        assert _flax_dim(kind, got, p.ndim) == want, (name, got, spec)
        n_sharded += got is not None
    assert n_sharded > 50


def test_zero_extend_matches_jax_zero_extend_spec():
    mesh = jmesh.make_mesh(4, 2, devices=jax.devices()[:8])
    for shape, base in [((3, 128, 16), P()), ((3, 128, 16), P(None, None, "model")),
                        ((7, 53), P()), ((128,), P()), ((1536, 1024), P("model", None)),
                        ((1025,), P()), ((12, 8), P())]:
        spec = jmesh.zero_extend_spec(base, shape, mesh)
        want = next((i for i, e in enumerate(spec) if e == "data"), None)
        taken = next((i for i, e in enumerate(base) if e == "model"), None)
        assert pmesh.zero_extend(shape, 4, taken) == want, (shape, base, spec)
    assert pmesh.zero_extend((128,), 1) is None


def test_zero_moment_bytes_fall_below_40_percent_at_8_ranks():
    """tests/test_zero_opt.py:51-62 at 8 data ranks: each rank keeps the
    1/8 slice of every moment the rule slices, and the whole of the rest."""
    model = PerformanceNet(ModelConfig(width_mult=1 / 16), device="meta")
    total = mine = 0
    for p in model.parameters():
        total += p.numel()
        mine += p.numel() // 8 if pmesh.zero_extend(p.shape, 8) is not None else p.numel()
    assert mine < 0.4 * total, (mine, total)


def test_make_mesh_needs_the_launch_ranks():
    import torch.distributed as dist

    for shape in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="the launch has 1"):
            pmesh.make_mesh(*shape, device="cpu")
    with pytest.raises(ValueError, match="the launch has 1 ranks"):
        pmesh.make_axis_mesh(2, "time", device="cpu")
    assert not dist.is_initialized()


def test_fold_seed_keeps_rank_0_and_separates_the_rest():
    seed = 0x0123456789ABCDEF
    assert dk.fold_seed(seed, 0) == seed
    folded = {dk.fold_seed(seed, k) for k in range(64)}
    assert len(folded) == 64 and all(0 <= s < 2**64 for s in folded)


# ---- training on the mesh --------------------------------------------------------

@pytest.mark.parametrize("name", MATCH_JAX)
def test_mesh_step_matches_jax_mesh_trainer(name, port_runs, jax_ref):
    got = port_runs[0][name]["losses"]
    want = jax_ref["losses"]
    assert abs(got[0] - want[0]) < 1e-4 * max(1.0, abs(want[0])), (got, want)
    assert abs(got[1] - want[1]) < 1e-3 * max(1.0, abs(want[1])), (got, want)
    for r in port_runs[1:]:  # every rank reports the global loss
        assert r[name]["losses"] == got


@pytest.mark.parametrize("zero, plain", [("zero", "dp"), ("zero_tp", "dp_tp"),
                                         ("zero_options", "dp_options"),
                                         ("zero_accum", "dp_accum")])
def test_zero_step_equals_the_unsharded_step(zero, plain, port_runs):
    """Adam is elementwise, so its slices give the unsharded update: bit
    for bit with plain Adam; with clipping the global norm is summed from
    the slices in another order, so within 1e-6 of the weights' scale."""
    got, want = port_runs[0][zero], port_runs[0][plain]
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-6)
    for k, v in want["params"].items():
        if "options" in zero:
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=1e-6 * max(1.0, np.abs(v).max()), err_msg=k)
        else:
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_zero_moment_bytes_fall_on_4_ranks(port_runs):
    """Each rank keeps about 1/n of the moments over n data ranks (4, or 2
    beside 2 model ranks), plus the few tensors no rank count divides."""
    for zero, plain, n in (("zero", "dp", 4), ("zero_tp", "dp_tp", 2)):
        for r in port_runs:
            ratio = r[zero]["moment_bytes"] / r[plain]["moment_bytes"]
            assert ratio < 1 / n + 0.1, (zero, n, ratio)
    # TP halves the sharded weights' moments on each model rank
    assert port_runs[0]["dp_tp"]["moment_bytes"] < 0.6 * port_runs[0]["dp"]["moment_bytes"]


@pytest.mark.parametrize("fmt", ["torch", "msgpack"])
def test_zero_tp_checkpoint_gathers_and_resumes(fmt, port_runs):
    """Saving gathers the ZeRO and TP slices whole; a fresh trainer that
    loads them takes the step the saved one takes."""
    for r in port_runs:
        res = r["checkpoint"]
        assert res[fmt]["params_equal"] and res[fmt]["moments_equal"]
        assert res[fmt]["loss"] == res["want_loss"]
        # msgpack keeps the learning rate as optax does, in float32: the
        # resumed step's lr differs from 1e-3 in its 8th digit
        assert res[fmt]["max_param_diff"] <= (0.0 if fmt == "torch" else 1e-7)


def test_data_sharded_store_gives_the_replicated_batch(port_runs):
    for r in port_runs:
        res = r["resident"]
        assert res["rows_held"] == 5
        assert res["batches_equal"]
        assert res["losses"]["data"] == res["losses"]["replicated"]
        assert all(np.isfinite(res["losses"]["data"]))


def test_dropout_masks_agree_over_model_ranks_and_differ_over_data_ranks(port_runs):
    """Train mode on a (2, 2) mesh, the same input on every rank: fc2's
    mask is the same on both model ranks (the replicas agree), the data
    ranks draw different masks (fold_seed)."""
    outs = {r["resident"]["coords"]: r["resident"]["train_out"] for r in port_runs}
    for d in (0, 1):
        np.testing.assert_array_equal(outs[(d, 0)], outs[(d, 1)])
    assert not np.allclose(outs[(0, 0)], outs[(1, 0)])


def test_dryrun_multichip_on_4_cpu_ranks(capsys):
    lines = launch.dryrun_multichip(4, device="cpu")
    want = ("dryrun_multichip OK", "ZeRO-1 OK", "resident OK", "sharded-GL OK",
            "time-sharded train OK", "hybrid OK")
    assert len(lines) == len(want)
    for line, w in zip(lines, want):
        assert w in line
    assert "dryrun_multichip OK: mesh={'data': 2, 'model': 2}" in capsys.readouterr().out
