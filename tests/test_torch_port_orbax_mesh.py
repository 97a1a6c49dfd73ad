"""The port's orbax checkpoints on a mesh (``train/checkpoint.py``'s
``save_checkpoint_orbax`` of ``Trainer.orbax_state``, ``load_orbax_sharded``,
``train/orbax_format.py``'s per-rank ``write_shards`` and ``commit``, region
reads) on the CPU, against the JAX package's orbax path on its virtual
mesh and against tensorstore.

The mesh runs are one spawn of 4 gloo ranks (``parallel/launch.spawn``; the
rank functions are in tests/torch_port_parallel_workers.py) at width 1/16,
float32, dropout off: (2, 2) and (4, 1) meshes with ZeRO-1 and an EMA.
Every comparison of checkpoint contents is bit for bit (``np.array_equal``):
a checkpoint moves bytes and computes nothing.
"""
import concurrent.futures
import functools
import itertools
import json
import math
import os
import time

import numpy as np
import pytest
import torch

import jax
import tensorstore as ts
import torch_port_parallel_workers as W
from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.config import TrainConfig as JTrainConfig
from ml_music_style_transfer_tpu.data import preprocess as jpp
from ml_music_style_transfer_tpu.parallel import mesh as jmesh
from ml_music_style_transfer_tpu.testing import synthetic
from ml_music_style_transfer_tpu.train import checkpoint as jckpt
from ml_music_style_transfer_tpu.train.loop import Trainer as JTrainer
from ml_music_style_transfer_tpu.train.optim import get_param_ema
from ml_music_style_transfer_tpu_torch.parallel import launch
from ml_music_style_transfer_tpu_torch.train import ocdbt

B, T = 4, 220
MESHES = [f"{d}x{m}" for d, m in W.ORBAX_MESHES]


def _batch(b=B, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "midi": (rng.random((b, T, 128)) < 0.05).astype(np.float32),
        "onoff": rng.choice([-1, 0, 1], (b, T, 128), p=[0.02, 0.96, 0.02]).astype(np.float32),
        "cond": rng.random((b, T, 1025)).astype(np.float32),
        "target": rng.random((b, T, 1025)).astype(np.float32),
        "weight": np.ones((b,), np.float32),
    }


def _leaves(tree, path=()):
    if hasattr(tree, "_asdict"):  # optax's named tuples
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        return _leaves({str(i): v for i, v in enumerate(tree)}, path)
    return {path: tree}


def _np(v):
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(got, want):
    """Leaf for leaf, dtypes included; an empty node (flax's ``{}``,
    orbax's ``None``) has no leaf."""
    g = {k: v for k, v in _leaves(got).items() if v is not None}
    w = {k: v for k, v in _leaves(want).items() if v is not None}
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:5]
    for k, v in w.items():
        a, b = _np(g[k]), _np(v)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        assert np.array_equal(a, b), ".".join(k)


@pytest.fixture(scope="module")
def tiny_h5(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbaxmeshdata")
    synthetic.make_dataset_dir(str(root / "raw"), song_ids=[9], styles=["cuba"],
                               duration=11.0, seed=6)
    for split in ("train", "test"):
        jpp.get_data(str(root / "raw"), str(root / "ds"), split, song_ids=[9], styles=["cuba"])
    return str(root / "ds")


def _write_jax_mesh_run(root) -> dict:
    """The JAX Trainer's state on its virtual (2, 2) mesh with ZeRO and an
    EMA (params TP-sharded, optimizer state ZeRO-sharded), its moments and
    EMA made random with their shardings kept, written by the JAX package
    as a msgpack and then as an orbax directory. Returns the JAX
    Trainer's fresh state: a template with its shardings."""
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    jtr = JTrainer(JModelConfig(**W.TINY_KW), JTrainConfig(batch_size=B, zero_opt=True,
                                                           ema_decay=0.9),
                   mesh=mesh, use_native_loader=False)
    params, opt = jtr.init_state(0)
    template = {"params": params, "opt_state": opt, "epoch": 0,
                "scheduler": jtr.scheduler.state_dict(), "ema_params": get_param_ema(opt)}
    rng = np.random.default_rng(11)

    def rand(x):
        if not x.ndim:
            return x
        noise = np.abs(rng.standard_normal(x.shape)).astype(x.dtype) * 1e-3
        return jax.device_put(np.asarray(x) + noise, x.sharding)

    opt = jax.tree_util.tree_map(rand, opt)
    state = {"params": params, "opt_state": opt, "epoch": 1,
             "scheduler": jtr.scheduler.state_dict(), "ema_params": get_param_ema(opt)}
    jckpt.save_checkpoint(str(root / "msgpack"), 1, state)
    jckpt.save_checkpoint_sharded(str(root), 1, state, wait=True)
    return template


def _written(path: str, ranks) -> str | None:
    """``path`` once the ranks have written it (None if they end without it)."""
    while not os.path.exists(path):
        if ranks.done():
            return None
        time.sleep(0.2)
    return path


def _jax_reads(path: str, template) -> tuple:
    """The JAX package's host restore of ``path`` and its restore into
    ``template``'s shardings."""
    return (jckpt.restore_checkpoint_sharded_host(path),
            jckpt.restore_checkpoint_sharded(path, template))


@pytest.fixture(scope="module")
def runs(tiny_h5, tmp_path_factory):
    """(the ranks' results, the JAX directory, its msgpack, the JAX
    template, {mesh: ``_jax_reads`` of the ranks' directory}): the JAX
    package writes its directory here while the 4 ranks run (they wait
    for it before they restore it), then reads theirs."""
    root = tmp_path_factory.mktemp("jaxmesh")
    tmp = str(tmp_path_factory.mktemp("orbaxmesh"))
    os.makedirs(root / "msgpack")
    paths = (jckpt.sharded_checkpoint_path(str(root), 1),
             str(root / "msgpack" / "checkpoint-1.msgpack"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, W.orbax_mesh, 4, (_batch(), tmp, *paths, tiny_h5),
                            device="cpu")
        try:
            template = _write_jax_mesh_run(root)
        except BaseException:
            open(root / "FAILED", "w").close()
            raise
        reads = {}
        for mesh in MESHES:
            path = _written(os.path.join(tmp, mesh, "checkpoint-1.orbax"), ranks)
            if path is None:
                break
            reads[mesh] = _jax_reads(path, template)
        return ranks.result(), *paths, template, reads


def _ts_keys(path: str) -> list:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    return kv.list().result()


@functools.lru_cache(maxsize=None)
def _store(path: str) -> tuple[dict, dict]:
    """({key: stored bytes}, {array name: its .zarray}) of the directory's
    root database."""
    with ocdbt.Database(path) as db:
        items = list(db.items())
        sizes = {k: len(v) if isinstance(v, bytes) else v.length for k, v in items}
        zarrays = {k[:-len(b"/.zarray")].decode(): json.loads(db.read(v))
                   for k, v in items if k.endswith(b"/.zarray")}
    return sizes, zarrays


def _bytes_to_read(path: str, regions: dict, tops) -> int:
    """The stored bytes of the chunks that meet each region's box (every
    chunk of a leaf with no region) and of the ``.zarray``s, under the
    top-level trees ``tops``."""
    sizes, zarrays = _store(path)
    total = 0
    for name, z in zarrays.items():
        keys = tuple(name.split("."))
        if keys[0] not in tops:
            continue
        total += sizes[f"{name}/.zarray".encode()]
        lo, size = regions.get(keys, ((0,) * len(z["shape"]), z["shape"]))
        ranges = [range(o // c, -(-(o + n) // c)) for o, n, c in zip(lo, size, z["chunks"])]
        for g in itertools.product(*ranges) if math.prod(size) else []:
            total += sizes[f"{name}/{'.'.join(map(str, g)) if g else '0'}".encode()]
    return total


def _whole(path: str, tops) -> int:
    return sum(n for k, n in _store(path)[0].items()
               if k.split(b"/")[0].split(b".")[0].decode() in tops)


class TestPortWritesOnAMesh:
    @pytest.mark.parametrize("mesh", MESHES)
    def test_jax_reads_the_four_rank_write(self, mesh, runs):
        """The JAX package's host restore of the directory the 4 ranks
        wrote is the state gathered before the save, bit for bit; so is its
        restore into the JAX Trainer's own shardings on its 4-device
        virtual (2, 2) mesh (TP and ZeRO); and the port's own whole read."""
        from ml_music_style_transfer_tpu_torch.train import orbax_format

        r0 = runs[0][0][mesh]
        want = r0["want"]
        host, got = runs[4][mesh]
        _assert_trees_equal(host, want)
        _assert_trees_equal(orbax_format.read(r0["path"]), want)
        template = runs[3]
        for key in ("params", "ema_params"):
            kernel = template[key]["params"]["up_0"]["Conv1x3_0"]["Conv_0"]["kernel"]
            assert len(kernel.sharding.device_set) == 4
            assert got[key]["params"]["up_0"]["Conv1x3_0"]["Conv_0"]["kernel"].sharding \
                == kernel.sharding
        _assert_trees_equal(got, want)

    @pytest.mark.parametrize("mesh", MESHES)
    def test_each_rank_writes_its_own_database_and_gathers_no_tensor(self, mesh, runs):
        """Every rank's ``ocdbt.process_{r}/`` is a database tensorstore
        lists; no chunk key is in two of them; the root lists them all and
        the ``.zarray``s. Saving gathered no tensor: the only all-gathers
        carried the ranks' lists of keys (uint8 pickles and their int64
        sizes)."""
        path = runs[0][0][mesh]["path"]
        per = [set(_ts_keys(os.path.join(path, f"ocdbt.process_{r}"))) for r in range(4)]
        assert all(per)
        chunks = [k for keys in per for k in keys]
        assert len(chunks) == len(set(chunks))
        root = set(_ts_keys(path))
        assert root == set(chunks) | {k for k in root if k.endswith(b"/.zarray")}
        for r in runs[0]:
            assert set(r[mesh]["save_gathers"]) <= {"torch.uint8", "torch.int64"}, \
                r[mesh]["save_gathers"]

    @pytest.mark.parametrize("restore_mesh", MESHES)
    @pytest.mark.parametrize("mesh", MESHES)
    def test_restore_reads_only_its_chunks(self, mesh, restore_mesh, runs):
        """A fresh trainer of either mesh restores each rank's slices: the
        state, gathered, is the saved one; each rank read exactly the
        stored bytes of the chunks that meet its blocks (and the
        ``.zarray``s), less than the whole."""
        path = runs[0][0][mesh]["path"]
        tops = ("params", "opt_state", "epoch", "scheduler")
        whole = _whole(path, tops)
        for r in runs[0]:
            got = r[mesh]["restored"][restore_mesh]
            assert got["epoch"] == 1
            _assert_trees_equal(got["state"], runs[0][0][mesh]["want"])
            assert got["value_bytes"] == _bytes_to_read(path, got["regions"], tops)
            assert got["value_bytes"] < 0.75 * whole

    @pytest.mark.parametrize("mesh", MESHES)
    def test_each_ranks_blocks_are_the_ones_cut_without_a_process_group(self, mesh, runs):
        """Every rank's ``orbax_state`` blocks (shape, place, size, dtype,
        writer) are ``loop.rank_orbax_state``'s for its rank, cut from the
        whole state with no process group: the tensor-parallel and ZeRO
        dims of the live trainer and of the one-process play agree."""
        for r in runs[0]:
            live, cut = r[mesh]["boxes"]
            assert live and live == cut

    def test_one_process_playing_the_ranks_writes_the_same_directory(self, runs):
        """Rank 0 wrote the (2, 2) directory again alone, as each rank in
        turn (``loop.rank_orbax_state`` cut from the whole state): each
        process database holds the same keys as the real rank's, and the
        whole read is bit-equal."""
        from ml_music_style_transfer_tpu_torch.train import orbax_format

        real, play = runs[0][0]["2x2"]["path"], runs[0][0]["2x2"]["played"]
        for r in range(4):
            assert (set(_ts_keys(os.path.join(real, f"ocdbt.process_{r}")))
                    == set(_ts_keys(os.path.join(play, f"ocdbt.process_{r}"))))
        _assert_trees_equal(orbax_format.read(play), orbax_format.read(real))

    def test_a_failed_rank_write_commits_nothing(self, runs):
        for r in runs[0]:
            assert "rank 2: OSError: disk full" in r["failed_write"]["error"]
            assert not r["failed_write"]["committed"]

    @pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema_params"])
    def test_serving_and_export_read_the_four_rank_write(self, use_ema, runs, tmp_path):
        """The (2, 2) directory as an experiment's best checkpoint: the
        synthesizer's weights (``load_checkpoint_params``) and the
        reference ``.tar`` that ``export_torch_checkpoint`` writes of it
        (``--epoch 1``) are the saved weights, whole."""
        from ml_music_style_transfer_tpu_torch.compat import weights
        from ml_music_style_transfer_tpu_torch.infer.synthesize import load_checkpoint_params
        from ml_music_style_transfer_tpu_torch.scripts import export_torch_checkpoint
        from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt

        path = runs[0][0]["2x2"]["path"]
        exp_dir = os.path.dirname(path)
        exp = ckpt.ExperimentState(1, 1, "2x2")
        exp.best_epoch = 1
        exp.save(exp_dir)
        assert ckpt.best_checkpoint(exp_dir) == (path, 1)
        tree = runs[0][0]["2x2"]["want"]["ema_params" if use_ema else "params"]
        want = {k: v.float() for k, v in weights.from_jax_params(
            {"params": _torch_tree(tree["params"])}).items()}
        got = load_checkpoint_params(path, use_ema=use_ema, device="cpu")
        assert set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items())
        out = str(tmp_path / "ref.tar")
        export_torch_checkpoint.main(["-exp-name", "2x2", "--exp-root", os.path.dirname(exp_dir),
                                      "--epoch", "1", "--device", "cpu", "--out", out]
                                     + (["--use-ema"] if use_ema else []))
        sd = torch.load(out, weights_only=True)["state_dict"]
        assert set(sd) == set(want) and all(torch.equal(sd[k], v) for k, v in want.items())


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


class TestPortRestoresAJaxMeshWrite:
    @pytest.mark.parametrize("mesh", MESHES)
    def test_equals_the_msgpack_restore_and_reads_only_its_chunks(self, mesh, runs):
        """The JAX package's (2, 2) ZeRO directory restored by the port's 4
        ranks into a (2, 2) and a (4, 1) placement: the same state as the
        msgpack of the same state restored whole; each rank read the
        stored bytes of the JAX chunks that meet its blocks (the JAX and
        the port's ZeRO may split different dims, so a block meets parts
        of chunks), less than the whole."""
        path = runs[1]
        tops = ("params", "opt_state", "epoch", "scheduler")
        whole = _whole(path, tops)
        for r in runs[0]:
            got = r["jax"][mesh]
            assert got["epoch"] == 1
            _assert_trees_equal(got["state"], r["jax_msgpack"])
            assert got["value_bytes"] == _bytes_to_read(path, got["regions"], tops)
            assert got["value_bytes"] < 0.75 * whole


class TestFitOnAMesh:
    def test_fit_saves_without_gathering_and_resumes_bit_equal(self, runs):
        """``fit(checkpoint_format="orbax")`` on the (2, 2) mesh: its saves
        gathered no tensor; a fresh trainer restored from its directory
        takes the same next step as the trainer that wrote it, loss and
        weights bit for bit; ``fit(resume=True)`` continues the run to a
        finite loss and leaves no uncommitted directory."""
        for r in runs[0]:
            fit = r["fit"]
            assert fit["latest"] == "checkpoint-1.orbax" and fit["epoch"] == 1
            assert set(fit["save_gathers"]) <= {"torch.uint8", "torch.int64"}
            assert fit["step_equal"]
            assert len(fit["loss_history"]) == 2 and np.all(np.isfinite(fit["loss_history"]))
        assert not any(f.endswith(".tmp") for f in runs[0][0]["fit"]["listing"])
