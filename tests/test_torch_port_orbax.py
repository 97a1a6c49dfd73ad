"""The port's orbax checkpoints against the JAX package, tensorstore and
zstandard, on the CPU at width 1/16: the zstd binding
(``train/zstd.py``), the OCDBT reader and writer (``train/ocdbt.py``), the
orbax layout (``train/orbax_format.py``) and the checkpoint layer that
serves and resumes from it. Every comparison of checkpoint contents is bit
for bit, dtypes included: a checkpoint moves bytes and computes nothing.
The served forward is held to 1e-4 relative plus 1e-4 of the peak, the
float32 forward's tolerance in test_torch_port_model.py.

The committed fixture ``tests/data/orbax_jax/checkpoint-1.orbax`` and its
expected leaves ``tests/data/orbax_jax_expected.npz`` were written by
``write_fixture`` below, with the JAX package on its virtual CPU mesh:
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
python tests/test_torch_port_orbax.py`` writes them again.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import tensorstore as ts
import zstandard
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.config import TrainConfig as JTrainConfig
from ml_music_style_transfer_tpu.data import preprocess as jpp
from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
from ml_music_style_transfer_tpu.testing import synthetic
from ml_music_style_transfer_tpu.train import checkpoint as jckpt
from ml_music_style_transfer_tpu.train.loop import Trainer as JTrainer
from ml_music_style_transfer_tpu_torch.compat import weights
from ml_music_style_transfer_tpu_torch.config import ModelConfig, TrainConfig
from ml_music_style_transfer_tpu_torch.infer.synthesize import build_model, load_checkpoint_params
from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt
from ml_music_style_transfer_tpu_torch.train import flax_msgpack, ocdbt, orbax_format, zstd
from ml_music_style_transfer_tpu_torch.train.loop import Trainer, stage_batch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "orbax_jax", "checkpoint-1.orbax")
EXPECTED = os.path.join(DATA, "orbax_jax_expected.npz")
TINY = dict(width_mult=1 / 16, compute_dtype="float32")
OPTS = dict(warmup_steps=3, ema_decay=0.9)  # the to_jax state's options
JAX_OPTS = dict(warmup_steps=3, ema_decay=0.9, grad_clip_norm=1.0)  # the JAX Trainer's
T = 220


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the committed fixture ----------------------------------------------------

def write_fixture(root: str) -> str:
    """The fixture's state written by the JAX package's
    ``save_checkpoint_sharded``: bf16, f32 and int32 arrays, 0-d arrays and
    Python scalars, a tuple (optax's ``EmptyState`` among its elements), an
    array sharded 4 ways (4 chunks), and a compressible array whose zstd
    frame has entropy-coded blocks and sits in a data file (indirect)."""
    rng = np.random.default_rng(12)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    sharded = jax.device_put(rng.standard_normal((8, 3)).astype(np.float32),
                             NamedSharding(mesh, PartitionSpec("x", None)))
    state = {
        "params": {"dense": {"kernel": rng.standard_normal((6, 5)).astype(np.float32),
                             "bias": jnp.asarray(rng.standard_normal(5), jnp.bfloat16)},
                   "sharded": sharded,
                   "levels": rng.integers(0, 16, (64, 64)).astype(np.float32)},
        "opt_state": ({"count": jnp.asarray(7, jnp.int32),
                       "mu": {"w": np.arange(12, dtype=np.int32).reshape(3, 4)}},
                      optax.EmptyState()),
        "epoch": 1,
        "scheduler": {"lr": 1e-3, "num_bad_epochs": 2},
    }
    return jckpt.save_checkpoint_sharded(root, 1, state, wait=True)


def flat(tree, path=()) -> dict:
    """{key: array} of a tree in the JAX layout, as the expected ``.npz``
    holds it: a bfloat16 tensor as its 16-bit words (``#bfloat16``), a
    Python scalar as a 0-d array (``#scalar``), an empty node as an empty
    array (``#empty``)."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    key = "/".join(path)
    if isinstance(tree, dict):
        return {f"{key}#empty": np.zeros(0)}
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return {f"{key}#bfloat16": tree.view(torch.int16).numpy()}
        return {key: tree.numpy()}
    return {f"{key}#scalar": np.asarray(tree)}


def _assert_flat_equal(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


def _msgpack_layout(tree):
    """The JAX package's host restore in flax's state-dict layout: a list
    keyed "0", "1", ...; ``None`` (optax's field-less states) as ``{}``;
    arrays as tensors, bfloat16 ones included."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _msgpack_layout(v) for k, v in tree.items()}
    if tree is None:
        return {}
    if isinstance(tree, (np.ndarray, jax.Array)):
        a = np.asarray(tree)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return tree


def _kv(path: str, **config):
    """tensorstore's OCDBT store at ``path`` (``config`` for a new one)."""
    spec = {"driver": "ocdbt", "base": f"file://{path}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _ts_items(path: str) -> dict:
    kv = _kv(path)
    keys = kv.list().result()
    reads = [kv.read(k) for k in keys]
    return {k: r.result().value for k, r in zip(keys, reads)}


def _port_items(path: str, prefix: bytes = b"") -> tuple[dict, int]:
    """Every key's value through the port's reader, and how many were
    indirect."""
    with ocdbt.Database(path) as db:
        items = list(db.items(prefix))
        return {k: db.read(v) for k, v in items}, sum(isinstance(v, ocdbt.Ref)
                                                       for _, v in items)


def _first_block_type(frame: bytes) -> int:
    """The Block_Type of a zstd frame's first block (RFC 8878 3.1.1)."""
    fhd = frame[4]
    single = (fhd >> 5) & 1
    fcs = [single, 2, 4, 8][fhd >> 6]
    head = 4 + 1 + (0 if single else 1) + [0, 1, 2, 4][fhd & 3] + fcs
    return (int.from_bytes(frame[head:head + 3], "little") >> 1) & 3


class TestCommittedFixture:
    def test_fixture_matches_the_jax_restore_and_the_expected_leaves(self):
        """The port's read of the committed directory is the JAX package's
        own restore of it and the committed expected leaves, and the
        directory holds what the fixture is for."""
        got = orbax_format.read(FIXTURE)
        _assert_flat_equal(flat(got), dict(np.load(EXPECTED)))
        _assert_flat_equal(flat(got), flat(_msgpack_layout(
            jckpt.restore_checkpoint_sharded_host(FIXTURE))))
        assert got["params"]["dense"]["bias"].dtype == torch.bfloat16
        assert got["opt_state"]["0"]["count"].dtype == torch.int32
        assert got["opt_state"]["0"]["count"].dim() == 0 and got["epoch"] == 1
        assert got["opt_state"]["1"] == {}  # optax.EmptyState, orbax's "None"
        with open(os.path.join(FIXTURE, "_METADATA")) as f:
            md = json.load(f)["tree_metadata"]
        assert md[repr(("opt_state", "0", "count"))]["key_metadata"][1]["key_type"] == 1
        items, n_indirect = _port_items(FIXTURE)
        assert sum(k.startswith(b"params.sharded/") and not k.endswith(b".zarray")
                   for k in items) == 4
        assert n_indirect >= 1 and _first_block_type(items[b"params.levels/0.0"]) == 2
        size = sum(os.path.getsize(os.path.join(d, n))
                   for d, _, names in os.walk(os.path.dirname(FIXTURE)) for n in names)
        assert size + os.path.getsize(EXPECTED) <= 1 << 20


# ---- zstd -------------------------------------------------------------------------

def _zstd_data() -> bytes:
    rng = np.random.default_rng(5)
    return (rng.integers(0, 8, 40_000).astype(np.uint8).tobytes() + bytes(20_000)
            + rng.bytes(3_000))


class TestZstd:
    @pytest.mark.parametrize("level", [1, 3, 19])
    @pytest.mark.parametrize("content_size", [True, False], ids=["sized", "unsized"])
    def test_against_zstandard(self, level, content_size):
        data = _zstd_data()
        frame = zstandard.ZstdCompressor(level=level,
                                         write_content_size=content_size).compress(data)
        assert zstd.content_size(frame) == (len(data) if content_size else None)
        assert zstd.decompress(frame) == data
        out = torch.empty(len(data), dtype=torch.uint8)
        zstd.decompress_into(frame, out.data_ptr(), len(data))
        assert out.numpy().tobytes() == data
        assert zstandard.ZstdDecompressor().decompress(zstd.compress(data)) == data

    def test_empty_frame_and_size_mismatch(self):
        assert zstd.decompress(zstandard.ZstdCompressor().compress(b"")) == b""
        assert zstandard.ZstdDecompressor().decompress(zstd.compress(b"")) == b""
        frame = zstd.compress(_zstd_data())
        out = torch.empty(len(_zstd_data()) - 1, dtype=torch.uint8)
        with pytest.raises(ValueError, match="where 62999 are expected"):
            zstd.decompress_into(frame, out.data_ptr(), out.numel())
        unsized = zstandard.ZstdCompressor(write_content_size=False).compress(_zstd_data())
        with pytest.raises(ValueError, match="zstd decompress"):
            zstd.decompress_into(unsized, out.data_ptr(), out.numel())
        assert zstd.version().count(".") == 2


# ---- JAX-written stores and states ---------------------------------------------------

def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"midi": (rng.random((2, T, 128)) < 0.05).astype(np.float32),
            "onoff": rng.choice([-1, 0, 1], (2, T, 128), p=[0.02, 0.96, 0.02]).astype(
                np.float32),
            "cond": rng.random((2, T, 1025)).astype(np.float32),
            "target": rng.random((2, T, 1025)).astype(np.float32),
            "weight": np.ones((2,), np.float32)}


def _port_trainer(seed=0, steps=1, **opts):
    """A CPU trainer after ``steps`` steps on ``_batch()``."""
    tr = Trainer(ModelConfig(**TINY), TrainConfig(batch_size=2, **opts), device="cpu")
    tr.init_state(seed)
    for s in range(steps):
        tr.train_step(stage_batch(_batch(), tr.device), s)
    return tr


def _numpy(tree):
    return ckpt.tree_map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, tree)


@pytest.fixture(scope="module")
def port_trainer():
    return _port_trainer(steps=0, **OPTS)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, port_trainer):
    """(orbax directory, msgpack) of one state, both written by the JAX
    package: the JAX Trainer's own state (optax's tuples and
    ``EmptyState``s; warmup, EMA and clipping) of a port Trainer's weights,
    with random moments and ``ema_params`` apart from the weights; every
    param whose first axis divides by 4 is sharded 4 ways on the virtual
    mesh (a grid of chunks), the other arrays are on one device. The orbax
    directory's hyperparams.json names its epoch; the msgpack is in its
    ``msgpack/`` folder."""
    root = tmp_path_factory.mktemp("jaxrun")
    jtr = JTrainer(JModelConfig(**TINY), JTrainConfig(batch_size=2, **JAX_OPTS),
                   use_native_loader=False)
    params = _numpy(weights.to_jax_params(port_trainer.model.state_dict()))
    rng = np.random.default_rng(8)

    def moment(v):
        v = np.asarray(v)
        if v.ndim == 0:
            return v
        return np.abs(rng.standard_normal(v.shape)).astype(v.dtype) * 1e-3

    shard = NamedSharding(Mesh(np.array(jax.devices()[:4]), ("x",)), PartitionSpec("x"))
    state = {"params": params,
             "opt_state": jax.tree_util.tree_map(moment, jax.jit(jtr.tx.init)(params)),
             "epoch": 1, "scheduler": jtr.scheduler.state_dict(),
             "ema_params": jax.tree_util.tree_map(
                 lambda v: v * 0.9 + rng.standard_normal(v.shape).astype(np.float32) * 0.01,
                 params)}
    state["params"] = jax.tree_util.tree_map(
        lambda v: jax.device_put(v, shard) if v.ndim and v.shape[0] % 4 == 0 else v, params)
    os.makedirs(root / "msgpack")
    out = (jckpt.save_checkpoint_sharded(str(root), 1, state, wait=True),
           jckpt.save_checkpoint(str(root / "msgpack"), 1, state))
    exp = jckpt.ExperimentState(1, 1, "jax_run")
    exp.best_epoch = 1
    exp.save(str(root))
    return out


def _interior_store(path: str) -> str:
    """A store tensorstore wrote with small nodes (interior nodes, inline
    and indirect values)."""
    kv = _kv(path, max_decoded_node_bytes=400, max_inline_value_bytes=16)
    rng = np.random.default_rng(2)
    txn = ts.Transaction()
    for i in range(60):
        kv.with_transaction(txn).write(f"g{i % 3}/k{i:03d}", rng.bytes(5 if i % 2 else 40)
                                       ).result()
    txn.commit_async().result()
    return path


class TestOcdbt:
    @pytest.mark.parametrize("store", ["fixture", "jax_run", "interior"])
    def test_reader_equals_tensorstore(self, store, request, tmp_path):
        """Every key and value, in tensorstore's order; a key prefix reads
        that range only."""
        if store == "fixture":
            path = FIXTURE
        elif store == "interior":
            path = _interior_store(str(tmp_path / "ts"))
        else:
            path = request.getfixturevalue("jax_run")[0]
        want = _ts_items(path)
        got, n_indirect = _port_items(path)
        assert list(got) == sorted(want) and got == want
        assert n_indirect > 0 and n_indirect < len(got)  # inline and indirect values
        prefix = sorted(want)[len(want) // 2][:4]
        assert _port_items(path, prefix)[0] == {k: v for k, v in want.items()
                                                if k.startswith(prefix)}
        with ocdbt.Database(path) as db:
            if store == "interior":
                assert db.root_height > 0

    @pytest.mark.parametrize("node_bytes", [ocdbt.MAX_DECODED_NODE_BYTES, 600],
                             ids=["one_leaf", "interior"])
    def test_writer_is_read_by_tensorstore(self, node_bytes, tmp_path, monkeypatch):
        rng = np.random.default_rng(4)
        values = {f"p{i % 5}.w/{i}.0".encode(): rng.bytes(2000 if i % 4 == 0 else i % 60)
                  for i in range(200)}
        monkeypatch.setattr(ocdbt, "DATA_FILE_BYTES", 10_000)
        w = ocdbt.Writer(str(tmp_path))
        w.config = ocdbt.Config(w.config.uuid, 0, w.config.max_inline_value_bytes,
                                node_bytes, 4, (1, 0))
        for k, v in values.items():
            w.put(k, v)
        w.commit()
        assert _ts_items(str(tmp_path)) == values
        got, n_indirect = _port_items(str(tmp_path))
        assert got == values and n_indirect == 50
        with ocdbt.Database(str(tmp_path)) as db:
            assert (db.root_height > 0) == (node_bytes == 600)


# ---- the orbax layer ----------------------------------------------------------------

def _assert_tree_equal(got, want, path=""):
    """Bit for bit, dtypes and Python scalar types included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got)
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, path
        assert got.shape == want.shape and torch.equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def jax_forward():
    """The JAX package's float32 forward, compiled once for both trees."""
    return jax.jit(JPerformanceNet(JModelConfig(**TINY)).apply)


class TestRestore:
    @pytest.mark.parametrize("keys", [None, ("params",), ("ema_params",),
                                      ("opt_state", "epoch", "scheduler")],
                             ids=["whole", "params", "ema_params", "rest"])
    def test_restore_equals_the_msgpack_of_the_same_state(self, keys, jax_run):
        """``restore_checkpoint(".orbax", keys)`` is ``flax_msgpack.load`` of
        the msgpack the JAX package wrote of the same state, leaf for leaf;
        sequences keyed "0", "1", ... and optax's ``EmptyState`` as ``{}``,
        as flax writes them."""
        opath, mpath = jax_run
        _assert_tree_equal(ckpt.restore_checkpoint(opath, keys=keys),
                           flax_msgpack.load(mpath, keys))

    def test_params_only_read_reads_only_the_params_bytes(self, jax_run):
        """``keys=("params",)`` reads the params' chunks and ``.zarray``s and
        nothing of the other trees: the bytes it counts are the stored
        bytes under ``params.``, a third of the whole."""
        path = jax_run[0]
        stored = _ts_items(path)
        params = sum(len(v) for k, v in stored.items() if k.startswith(b"params."))
        stats = {}
        orbax_format.read(path, keys=("params",), stats=stats)
        assert stats["value_bytes"] == params
        assert 3 * params < sum(map(len, stored.values()))

    @pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema_params"])
    def test_served_forward_equals_the_jax_forward(self, use_ema, jax_run, jax_forward):
        """The served weights of the JAX Trainer's directory (through
        ``best_checkpoint``, as the synthesizer resolves them) in a float32
        forward, against the JAX package's forward of its own restore of
        the same tree."""
        exp_dir = os.path.dirname(jax_run[0])
        path, epoch = ckpt.best_checkpoint(exp_dir)
        assert (path, epoch) == jckpt.best_checkpoint(exp_dir) and path.endswith(".orbax")
        key = "ema_params" if use_ema else "params"
        model = build_model(ModelConfig(**TINY), load_checkpoint_params(path, use_ema), "cpu")
        rng = np.random.default_rng(6)
        midi = (rng.random((1, T, 128)) < 0.05).astype(np.float32)
        spec = rng.uniform(0.0, 4.0, (1, T, 1025)).astype(np.float32)
        onoff = rng.integers(-1, 2, (1, T, 128)).astype(np.float32)
        jparams = jax.tree_util.tree_map(np.asarray, jckpt.restore_params_sharded_host(path, key))
        want = np.asarray(jax_forward(jparams, midi, spec, onoff))
        with torch.no_grad():
            got = model(*map(torch.from_numpy, (midi, spec, onoff))).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny_h5(tmp_path_factory):
    """A synthetic preprocessed dataset written by the JAX package."""
    root = tmp_path_factory.mktemp("orbaxdata")
    synthetic.make_dataset_dir(str(root / "raw"), song_ids=[7], styles=["cuba"],
                               duration=11.0, seed=5)
    for split in ("train", "test"):
        jpp.get_data(str(root / "raw"), str(root / "ds"), split, song_ids=[7],
                     styles=["cuba"])
    return str(root / "ds")


class TestTrainer:
    def test_fit_resumes_a_jax_orbax_as_its_msgpack(self, jax_run, tiny_h5, tmp_path,
                                                   monkeypatch):
        """The JAX Trainer's directory resumed by ``fit(resume=True)``: the
        trainer's state equals the one resumed from the msgpack of the same
        state."""
        monkeypatch.chdir(tmp_path)
        opath, mpath = jax_run
        states = []
        for name, src in (("o", opath), ("m", mpath)):
            d = os.path.join("experiments", name)
            os.makedirs(d)
            (shutil.copytree if os.path.isdir(src) else shutil.copy)(
                src, os.path.join(d, os.path.basename(src)))
            shutil.copy(os.path.join(os.path.dirname(opath), "hyperparams.json"), d)
            tr = Trainer(ModelConfig(**TINY), TrainConfig(epochs=1, exp_name=name,
                                                          batch_size=2, **JAX_OPTS),
                         device="cpu")
            tr.fit(tiny_h5, resume=True)
            states.append(tr.state_dict(1))
        _assert_tree_equal(states[0], states[1])

    @pytest.mark.parametrize("chunk_bytes", [orbax_format.CHUNK_BYTES, 200_000],
                             ids=["whole_arrays", "chunk_grids"])
    def test_port_written_orbax_restores_in_jax(self, chunk_bytes, port_trainer, tmp_path,
                                                monkeypatch):
        """``save_checkpoint_orbax`` (asynchronous) of a Trainer's JAX-layout
        state: the JAX package's host restore equals that state as it was
        at the call, tensorstore lists it, and the port reads it back; with
        arrays whole (at width 1/16 each fits a chunk) and cut into grids
        of chunks (``orbax_format.chunking``)."""
        monkeypatch.setattr(orbax_format, "CHUNK_BYTES", chunk_bytes)
        clone = lambda t: ckpt.tree_map(  # noqa: E731
            lambda v: v.clone() if isinstance(v, torch.Tensor) else v, t)
        state = clone(port_trainer.jax_state_dict(1))
        path = ckpt.save_checkpoint_orbax(str(tmp_path), 1, state)
        want = clone(state)
        ckpt.tree_map(lambda v: v.add_(1) if isinstance(v, torch.Tensor) else v,
                      state)  # the write has its own copy
        ckpt.wait_for_async_saves()
        assert not os.path.exists(f"{path}.tmp") and ckpt.latest_checkpoint(
            str(tmp_path)) == (path, 1)
        want = _msgpack_layout(_numpy(want))
        _assert_tree_equal(_msgpack_layout(jckpt.restore_checkpoint_sharded_host(path)), want)
        chunk_keys = [k for k in _ts_items(path) if not k.endswith(b".zarray")]
        assert any(k.endswith(b"/1.0.0") for k in chunk_keys) == (chunk_bytes < 1 << 20)
        _assert_tree_equal(ckpt.restore_checkpoint(path), want)


# ---- the optax structure: the JAX package's fit resumes a port-written run ------------

# the two option sets: none, and every optimizer option (bf16 moments
# through adam_compact); the JAX fit's resume template has no ema_params,
# so with an EMA it refuses its own directories (below)
FIT_OPTS = {"plain": {},
            "all": dict(grad_accum=2, grad_clip_norm=1.0, warmup_steps=4, ema_decay=0.999,
                        adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16")}
NO_EMA = {k: v for k, v in FIT_OPTS["all"].items() if k != "ema_decay"}


def _tree_md(path: str) -> dict:
    """{key path: (key types, value type, skip_deserialize)} of ``_METADATA``."""
    with open(os.path.join(path, "_METADATA")) as f:
        md = json.load(f)["tree_metadata"]
    return {k: ([m["key_type"] for m in v["key_metadata"]], v["value_metadata"]["value_type"],
                v["value_metadata"]["skip_deserialize"]) for k, v in md.items()}


def _jtrainer(opts, root, epochs=1, name="j"):
    return JTrainer(JModelConfig(**TINY), JTrainConfig(epochs=epochs, exp_name=name,
                                                       batch_size=2, **opts),
                    exp_root=str(root), use_native_loader=False)


@pytest.fixture(scope="module")
def port_fits(tiny_h5, tmp_path_factory):
    """{option set: the experiment root of a port ``fit`` of one epoch with
    ``checkpoint_format="orbax"``, and the trainer's state}."""
    out = {}
    for name, opts in {**FIT_OPTS, "no_ema": NO_EMA}.items():
        root = tmp_path_factory.mktemp(f"portfit_{name}")
        tr = Trainer(ModelConfig(**TINY), TrainConfig(epochs=1, exp_name=name, batch_size=2,
                                                      **opts),
                     exp_root=str(root), device="cpu")
        tr.fit(tiny_h5, checkpoint_format="orbax")
        out[name] = (str(root), tr.jax_state_dict(1))
    return out


@pytest.fixture(scope="module")
def jax_writes(tmp_path_factory):
    """{option set: (the directory the JAX package's
    ``save_checkpoint_sharded`` wrote of the JAX Trainer's fresh state of
    that config, that state as a template)}."""
    from ml_music_style_transfer_tpu.train.optim import get_param_ema

    out = {}
    for name, opts in FIT_OPTS.items():
        root = tmp_path_factory.mktemp(f"jaxwrite_{name}")
        jtr = _jtrainer(opts, root)
        params, opt = jtr.init_state(0)
        state = {"params": params, "opt_state": opt, "epoch": 1,
                 "scheduler": jtr.scheduler.state_dict()}
        if "ema_decay" in opts:
            state["ema_params"] = get_param_ema(opt)
        out[name] = (jckpt.save_checkpoint_sharded(str(root / "j"), 1, state, wait=True), state)
    return out


class _Resumed(Exception):
    pass


class TestOptaxStructure:
    @pytest.mark.parametrize("opts", list(FIT_OPTS))
    def test_tree_metadata_equals_the_jax_packages_write(self, opts, port_fits, jax_writes):
        """Key path by key path, key types (sequence indices 1, dict keys
        and named tuples' fields 2) and value types (``jax.Array``,
        ``scalar``; ``EmptyState`` ``None``, ``skip_state`` ``Tuple``,
        ``hyperparams_states`` ``Dict``): the port's ``fit`` wrote what the
        JAX package's ``save_checkpoint_sharded`` writes of the JAX
        Trainer's state of the same config."""
        root = port_fits[opts][0]
        port = _tree_md(ckpt.checkpoint_path(os.path.join(root, opts), 1, "orbax"))
        want = _tree_md(jax_writes[opts][0])
        assert port == want
        types = {v[1] for v in want.values()}
        assert {"jax.Array", "scalar", "None", "Dict"} <= types
        assert ("Tuple" in types) == (opts == "all")

    @pytest.mark.parametrize("opts", ["plain", "no_ema"])
    def test_jax_fit_resumes_a_port_fit(self, opts, port_fits, tiny_h5, monkeypatch):
        """The JAX package's ``Trainer.fit(resume=True,
        checkpoint_format="orbax")`` in the port's experiment directory
        restores the port's directory into its optax template and goes on
        to train at the port's epoch from the port's params and optimizer
        state, leaf for leaf (its first epoch is stopped on entry); with no
        option and with every option but the EMA."""
        from flax import serialization

        root, want = port_fits[opts]
        seen = {}

        def spy(self, params, opt_state, dataset, epoch, rng, **kw):
            seen["at"] = (epoch, jax.device_get(params),
                          serialization.to_state_dict(jax.device_get(opt_state)))
            raise _Resumed

        monkeypatch.setattr(JTrainer, "train_epoch", spy)
        jtr = _jtrainer({"plain": {}, "no_ema": NO_EMA}[opts], root, epochs=2, name=opts)
        with pytest.raises(_Resumed):
            jtr.fit(tiny_h5, resume=True, checkpoint_format="orbax")
        epoch, params, opt = seen["at"]
        assert epoch == 1
        _assert_tree_equal(_msgpack_layout(params), _msgpack_layout(want["params"]))
        _assert_tree_equal(_msgpack_layout(opt),
                           _msgpack_layout(weights.flax_state_dict(want["opt_state"])))

    def test_with_an_ema_the_jax_fit_refuses_port_and_jax_directories_alike(
            self, port_fits, jax_writes, tiny_h5):
        """With every option and an EMA, the JAX ``fit``'s resume template
        lacks ``ema_params``, so orbax refuses the JAX package's own
        directory; it refuses the port's with the same error, and the JAX
        restore into that template plus ``ema_params`` takes the port's
        directory, equal to the port's state."""
        from flax import serialization

        root, want = port_fits["all"]
        jpath, template = jax_writes["all"]
        shutil.copy(os.path.join(root, "all", "hyperparams.json"), os.path.dirname(jpath))
        errors = []
        for exp_root, name in ((os.path.dirname(os.path.dirname(jpath)), "j"), (root, "all")):
            with pytest.raises(ValueError, match="tree structures do not match") as e:
                _jtrainer(FIT_OPTS["all"], exp_root, epochs=2, name=name).fit(
                    tiny_h5, resume=True, checkpoint_format="orbax")
            assert "ema_params" in str(e.value)
            errors.append(str(e.value).split("\n")[:2])
        assert errors[0] == errors[1]
        got = jckpt.restore_checkpoint_sharded(
            ckpt.checkpoint_path(os.path.join(root, "all"), 1, "orbax"), template)
        got["opt_state"] = serialization.to_state_dict(got["opt_state"])
        _assert_tree_equal(_msgpack_layout(jax.device_get(got)),
                           _msgpack_layout(weights.flax_state_dict(want)))


# ---- corrupt directories ---------------------------------------------------------------

def _root_node(path: str) -> str:
    with ocdbt.Database(path) as db:
        return os.path.join(path, db.root_ref.file.path)


def _flip(path):
    node = _root_node(path)
    with open(node, "r+b") as f:
        f.seek(os.path.getsize(node) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x40]))


def _truncate(path):
    node = _root_node(path)
    os.truncate(node, os.path.getsize(node) - 10)


def _drop_chunk(path):
    kv = _kv(path)
    kv.delete_range(ts.KvStore.KeyRange(b"params.sharded/2.0", b"params.sharded/2.0\0")
                    ).result()


def _zarray(field, value):
    def edit(path):
        kv = _kv(path)
        z = json.loads(kv.read("params.dense.kernel/.zarray").result().value)
        z[field] = value
        kv.write("params.dense.kernel/.zarray", json.dumps(z)).result()
    return edit


def _zarr3(path):
    with open(os.path.join(path, "_METADATA")) as f:
        md = json.load(f)
    md["use_zarr3"] = True
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(md, f)


class TestCorruption:
    @pytest.mark.parametrize("corrupt,match", [
        (_flip, "crc32c mismatch"),
        (_truncate, "truncated"),
        (_drop_chunk, "chunk params.sharded/2.0 of params.sharded is missing"),
        (_zarr3, "use_zarr3: true"),
        (_zarray("dtype", ">f4"), "dtype '>f4'"),
        (_zarray("compressor", {"id": "blosc"}), "compressor 'blosc'"),
    ], ids=["flipped_byte", "truncated_node", "missing_chunk", "zarr3", "dtype",
            "compressor"])
    def test_raises_and_returns_no_tree(self, corrupt, match, tmp_path):
        path = str(tmp_path / "checkpoint-1.orbax")
        shutil.copytree(FIXTURE, path)
        orbax_format.read(path)  # the copy reads
        corrupt(path)
        with pytest.raises(ValueError, match=match):
            ckpt.restore_checkpoint(path)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    out = os.path.join(DATA, "orbax_jax")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    written = write_fixture(out)
    np.savez(EXPECTED, **flat(_msgpack_layout(jckpt.restore_checkpoint_sharded_host(written))))
    print(written, file=sys.stderr)
