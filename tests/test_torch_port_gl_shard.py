"""The port's time-sharded Griffin-Lim (``parallel/gl_shard.py``), bulk
Griffin-Lim over the data ranks (``infer/bulk.py``) and the serving daemon
on a mesh (``scripts/serve.py --mesh-data``), on the CPU.

The JAX side runs ``gl_shard.sharded_griffinlim_from_log_power`` on its
virtual CPU mesh of the same device count (tests/conftest.py), and hands
its own initial phase field (drawn from ``PRNGKey(seed)``) to the port as
``init_phase``; the port runs on gloo ranks. Tolerances: one rank is bit
for bit one device's ``griffinlim``; against the JAX package the
waveforms agree within 1e-3 of their peak (the port's single-clip
Griffin-Lim tolerance, tests/test_torch_port_dsp.py); on 4 ranks the
spectral error stays within 1.15x the single-device one
(tests/test_gl_shard.py:74-86). Bulk Griffin-Lim over the data ranks is
held clip for clip against JAX ``bulk_griffinlim`` on the same mesh size,
each clip starting from JAX's phase for its seed, within 1e-3 of the
peak.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_port_parallel_workers as W
from ml_music_style_transfer_tpu.infer import bulk as jbulk
from ml_music_style_transfer_tpu.parallel import mesh as jmesh
from ml_music_style_transfer_tpu.parallel import gl_shard as jgl_shard
from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.data import audio_io
from ml_music_style_transfer_tpu_torch.infer import synthesize as S
from ml_music_style_transfer_tpu_torch.midi import writer as midi_writer
from ml_music_style_transfer_tpu_torch.models import PerformanceNet
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import stft as tstft
from ml_music_style_transfer_tpu_torch.parallel import gl_shard, launch
from ml_music_style_transfer_tpu_torch.testing import synthetic

N_FFT, HOP = 512, 64  # 8 hops per window: the glue's shape, as at 2048 / 256
T_FRAMES = 160        # 40 frames per rank on 4
KW = dict(n_iter=60, hop_length=HOP, halo=8, rounds=10)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _harmonic_spec(t_frames: int = T_FRAMES, seed: int = 0) -> np.ndarray:
    """(T, bins) log-power spec of a harmonic clip whose chord moves up a
    fifth halfway (so the seams fall on real structure)."""
    rng = np.random.default_rng(seed)
    n = HOP * (t_frames - 1)
    t = np.arange(n) / 16000.0
    y = np.zeros(n, np.float64)
    for f0 in (220.0, 277.2, 329.6):
        for k in range(1, 5):
            f = f0 * k * np.where(np.arange(n) < n // 2, 1.0, 1.5)
            y += 0.4 / k * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    y *= np.hanning(n) ** 0.25
    spec = tstft.log_power_stft(torch.from_numpy(y.astype(np.float32)), N_FFT, HOP).numpy()
    return np.ascontiguousarray(spec[:, :t_frames].T)


def _spectral_err(wav, spec) -> float:
    got = tstft.log_power_stft(torch.as_tensor(wav), N_FFT, HOP).numpy()
    t = min(got.shape[1], spec.shape[0])
    return float(np.mean(np.abs(got[:, :t] - spec[:t].T)))


def _jax(spec, n, seed=0, **kw):
    """The JAX sharded Griffin-Lim on n virtual devices, and its phase field."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("time",))
    field = jgl_shard._phase_field_jit(jgl_shard._mesh_key(mesh), "time")(
        seed, spec.shape[1], spec.shape[0])
    wav = jgl_shard.sharded_griffinlim_from_log_power(spec, mesh, seed=seed, **kw)
    return np.asarray(wav), np.ascontiguousarray(np.asarray(field).T)


def _specs():
    return np.stack([_harmonic_spec(30, s).T for s in range(4)])  # (4, bins, 30)


def _jax_bulk_fields(specs):
    """The initial phase JAX ``bulk_griffinlim`` draws for clip i from seed
    i (ops/griffinlim.py: 2 pi * uniform(PRNGKey(seed)))."""
    return np.stack([np.asarray(2.0 * jnp.pi * jax.random.uniform(jax.random.PRNGKey(i),
                                                                   s.shape))
                     for i, s in enumerate(specs)])


def _clip_dir(tmp):
    model = PerformanceNet(ModelConfig(width_mult=1 / 16, compute_dtype="float32"),
                           generator=torch.Generator().manual_seed(0))
    np.savez(os.path.join(tmp, "state.npz"),
             **{k: v.numpy() for k, v in model.state_dict().items()})
    for name, seconds, seed in (("a", 4.0, 11), ("b", 3.0, 12)):
        notes = synthetic.random_song(np.random.default_rng(seed), duration=seconds)
        midi_writer.save(os.path.join(tmp, f"{name}.mid"), notes)
        audio_io.write_wav(os.path.join(tmp, f"{name}.wav"),
                           synthetic.render_notes(notes, "harpsichord", 44100, seconds), 44100)
    shutil.copy(os.path.join(tmp, "a.mid"), os.path.join(tmp, "c.mid"))  # absent on rank 1
    return tmp


@pytest.fixture(scope="module")
def jax_ref():
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh (tests/conftest.py)")
    spec = _harmonic_spec()
    out = {n: _jax(spec, n, **KW) for n in (1, 2, 4)}
    specs = _specs()
    out["bulk"] = {n: np.asarray(jbulk.bulk_griffinlim(
        specs, np.arange(len(specs), dtype=np.int32),
        mesh=jmesh.make_mesh(n, 1, devices=jax.devices()[:n]), n_iter=3, hop_length=HOP))
        for n in (2, 4)}
    return out


@pytest.fixture(scope="module")
def port(jax_ref, tmp_path_factory):
    spec = _harmonic_spec()
    clip_dir = _clip_dir(str(tmp_path_factory.mktemp("clips")))
    specs = _specs()
    return {n: launch.spawn(W.sharded_gl, n, (n, spec, jax_ref[n][1], KW, specs,
                                              _jax_bulk_fields(specs),
                                              clip_dir if n == 2 else None), device="cpu")
            for n in (2, 4)}


def test_one_rank_is_griffinlim_bit_for_bit(jax_ref):
    spec = _harmonic_spec(64)
    field = gl_shard.phase_field(spec.shape[1], 64, seed=3)
    got = gl_shard.sharded_griffinlim_from_log_power(
        spec, None, n_iter=20, hop_length=HOP, seed=3, device="cpu").numpy()
    want = tgl.griffinlim(tstft.inverse_log_power(torch.from_numpy(spec.T.copy())),
                          n_iter=20, hop_length=HOP, init_phase=field, device="cpu").numpy()
    assert got.shape == (64 * HOP,)
    np.testing.assert_array_equal(got[:want.shape[0]], want)
    assert np.all(got[want.shape[0]:] == 0)
    # and the seed's field is griffinlim's own draw
    np.testing.assert_array_equal(got, gl_shard.sharded_griffinlim_from_log_power(
        spec, None, n_iter=20, hop_length=HOP, init_phase=field, device="cpu").numpy())


def test_one_rank_matches_jax_from_its_field(jax_ref):
    want, field = jax_ref[1]
    got = gl_shard.sharded_griffinlim_from_log_power(
        _harmonic_spec(), None, init_phase=torch.from_numpy(field), device="cpu", **KW).numpy()
    assert got.shape == want.shape == (T_FRAMES * HOP,)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_jax_from_its_field(n, port, jax_ref):
    want = jax_ref[n][0]
    for r in port[n]:
        assert r["wav"].shape == want.shape == (T_FRAMES * HOP,)
        np.testing.assert_allclose(r["wav"], want, atol=1e-3 * np.abs(want).max())


def test_four_ranks_reach_the_single_device_spectral_error(port, jax_ref):
    spec = _harmonic_spec()
    one = gl_shard.sharded_griffinlim_from_log_power(
        spec, None, init_phase=torch.from_numpy(jax_ref[4][1]), device="cpu", **KW).numpy()
    err_sh, err_1 = _spectral_err(port[4][0]["wav"], spec), _spectral_err(one, spec)
    assert err_sh <= 1.15 * err_1, (err_sh, err_1)


@pytest.mark.parametrize("n", [2, 4])
def test_seed_determinism_and_errors(n, port):
    res = port[n][0]
    assert res["same_seed_equal"] and res["other_seed_differs"]
    divide, halo = res["errors"]
    assert divide is not None and "must divide" in divide
    assert halo is not None and "halo" in halo


@pytest.mark.parametrize("n", [2, 4])
def test_bulk_over_data_ranks_equals_per_clip(n, port):
    """Each rank's clips are its own: bit for bit the clips run one by one
    in the same process (one thread), and within float32 rounding of them
    in this one (two threads: the FFTs may sum in another order)."""
    specs = _specs()
    want = np.stack([tgl.griffinlim_from_log_power(
        s, generator=torch.Generator().manual_seed(i), n_iter=3, hop_length=HOP,
        device="cpu").numpy()
        for i, s in enumerate(specs)])
    for r in port[n]:
        np.testing.assert_array_equal(r["bulk"], r["per_clip"])
        np.testing.assert_allclose(r["bulk"], want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", [2, 4])
def test_bulk_over_data_ranks_matches_jax(n, port, jax_ref):
    """Clip for clip against JAX ``bulk_griffinlim`` on an n-device mesh,
    each clip from JAX's phase for its seed."""
    want = jax_ref["bulk"][n]
    for r in port[n]:
        got = r["bulk_from_fields"]
        assert got.shape == want.shape == (4, 29 * HOP)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max())


def _daemon_synth(clip_dir, name):
    state = {k: torch.from_numpy(v)
             for k, v in np.load(os.path.join(clip_dir, "state.npz")).items()}
    return S.AudioSynthesizer(clip_dir, os.path.join(clip_dir, f"{name}.mid"),
                              os.path.join(clip_dir, "a.wav"),
                              model_cfg=ModelConfig(width_mult=1 / 16, compute_dtype="float32"),
                              params=state, device="cpu")


def test_daemon_on_a_two_rank_mesh(port):
    """Rank 0 answers a batch (its bad items failing alone) and whole-clip
    requests; the batch's items equal single requests; the gathered whole
    clip stays within 1e-3 of its peak of the one-device one (the
    time-sharded forward's rounding), and so does the sharded one of the
    same sharded Griffin-Lim run on the one-device forward."""
    res = port[2][0]["daemon"]
    batch, whole, sharded = res["responses"][:3]
    assert [it["ok"] for it in batch["batch"]] == [True, False, True, False]
    assert whole["ok"] and sharded["ok"]
    clip_dir = os.path.dirname(whole["out"])
    for i, name in ((0, "a"), (2, "b")):
        got, _ = audio_io.read_wav(batch["batch"][i]["out"], sr=None)
        want = _daemon_synth(clip_dir, name).synthesize_waveform(n_iter=2)
        np.testing.assert_allclose(got, want, atol=1e-4)
    want = _daemon_synth(clip_dir, "a").synthesize_whole_clip(n_iter=2)
    got, _ = audio_io.read_wav(whole["out"], sr=None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
    want = port[2][0]["daemon"]["one_device_sharded_gl"]
    np.testing.assert_array_equal(want, port[2][1]["daemon"]["one_device_sharded_gl"])
    got, _ = audio_io.read_wav(sharded["out"], sr=None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_daemon_skips_what_a_rank_cannot_prepare(port):
    """A file missing on rank 1 fails that batch item and that whole-clip
    request (which every rank then skips), with rank 1's error; options that cannot run
    fail before any collective; the mesh then goes on serving."""
    res = port[2][0]["daemon"]
    batch, _, _, missing, bad_halo, after = res["responses"]
    err = batch["batch"][3]["error"]  # item 3 runs on rank 1 (bulk.py: item i on i mod n)
    assert "FileNotFoundError" in err and "absent" in err
    assert not missing["ok"] and missing["error"].startswith("rank 1: FileNotFoundError")
    assert not bad_halo["ok"] and "halo" in bad_halo["error"]
    assert after["ok"] and os.path.getsize(after["out"]) > 0
    assert res["served"] == 5  # two batch items and three whole clips
    assert port[2][1]["daemon"]["followed"] == 5  # the bad halo never left rank 0
