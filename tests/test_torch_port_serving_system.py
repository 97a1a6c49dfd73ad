"""The port's serving system on the CPU: the whole-clip one-pass path
against the JAX package's (a 1-device time mesh), the dynamic batch against
single requests, the warm model cache, the transfer seams, the JSON-lines
daemon (mirroring tests/test_inference.py's daemon tests against the port's
``serve_loop``), and the device contract of the new entry points. Width
1/16, float32, weights carried across by ``compat/weights.from_jax_params``;
inputs are written with the port's own synthetic module."""
import io
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from ml_music_style_transfer_tpu.compat import save_reference_checkpoint
from ml_music_style_transfer_tpu.compat.torch_import import convert_state_dict
from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.infer import AudioSynthesizer as JSynth
from ml_music_style_transfer_tpu_torch.compat import from_jax_params
from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.data import audio_io
from ml_music_style_transfer_tpu_torch.infer import bulk
from ml_music_style_transfer_tpu_torch.infer import synthesize as S
from ml_music_style_transfer_tpu_torch.midi import writer as midi_writer
from ml_music_style_transfer_tpu_torch.models import PerformanceNet
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.parallel import time_shard as tsh
from ml_music_style_transfer_tpu_torch.scripts import bench_inference, serve
from ml_music_style_transfer_tpu_torch.testing import synthetic
from ml_music_style_transfer_tpu_torch.train import checkpoint as ckpt

TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32")
TINY = ModelConfig(**TINY_KW)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_cache():
    S.clear_caches()
    yield
    S.clear_caches()


@pytest.fixture(scope="module")
def flax_params():
    """Seeded xavier-normal weights as a flax tree (drawn by the port's
    model: a JAX ``model.init`` at this width costs 20-45 s on the CPU)."""
    model = PerformanceNet(TINY, generator=torch.Generator().manual_seed(0))
    return convert_state_dict({k: v.detach().numpy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def state(flax_params):
    return from_jax_params(flax_params)


def _clip(d, name, seconds, seed, timbre_seconds=None, style="harpsichord"):
    notes = synthetic.random_song(np.random.default_rng(seed), duration=seconds)
    midi, wav = str(d / f"{name}.mid"), str(d / f"{name}.wav")
    midi_writer.save(midi, notes)
    audio_io.write_wav(wav, synthetic.render_notes(notes, style, 44100,
                                                   timbre_seconds or seconds), 44100)
    return midi, wav


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """8 s and 12 s songs with their renderings, and a 3 s song with a 2 s
    timbre clip (shorter than one chunk and than the MIDI)."""
    d = tmp_path_factory.mktemp("clips")
    return {"a": _clip(d, "a", 8.0, 11), "b": _clip(d, "b", 12.0, 12, style="cuba"),
            "short": _clip(d, "short", 3.0, 13, timbre_seconds=2.0)}


def _synth(midi, wav, state, exp_dir=".", **kw):
    return S.AudioSynthesizer(exp_dir, midi, wav, model_cfg=TINY, params=state, device="cpu", **kw)


class TestWholeClip:
    @pytest.mark.parametrize("clip", ["a", "short"])
    def test_spectrogram_matches_jax_one_device_mesh(self, clip, clips, flax_params, state):
        midi, wav = clips[clip]
        jsynth = JSynth(".", midi, wav, model_cfg=JModelConfig(**TINY_KW), params=flax_params)
        roll, onoff, cond, t_total = jsynth.process_whole_clip(midi, wav)
        tsynth = _synth(midi, wav, state)
        got_roll, got_onoff, got_cond, got_t = tsynth.process_whole_clip(midi, wav)
        assert got_t == t_total
        np.testing.assert_array_equal(got_roll, roll)
        np.testing.assert_array_equal(got_onoff, onoff)
        np.testing.assert_allclose(got_cond, cond, atol=1e-3)  # log-space contract
        want = jsynth.predict_spectrogram_whole_clip(
            roll, onoff, cond, t_total, mesh=Mesh(np.array(jax.devices()[:1]), ("time",)))
        got = tsynth.predict_spectrogram_whole_clip(roll, onoff, cond, t_total)
        assert got.shape == want.shape == (tsh.time_sharded_output_length(t_total), 1025)
        # float32 through ~30 layers: the port's forward tolerance
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())

    def test_the_two_clip_lengths_cover_odd_and_sub_chunk(self, clips):
        lengths = [S.pr.vectorize_notes(S.midi_parser.load(clips[c][0]).notes, 172)[0].shape[0]
                   for c in ("a", "short")]
        assert lengths[0] % 16 != 0 or lengths[1] % 16 != 0
        assert min(lengths) < 860

    @pytest.mark.parametrize("t", [16, 17, 100, 431, 1000, 1023])
    def test_forward_length_follows_the_ladder(self, t, state):
        model = S.build_model(TINY, state, "cpu")
        rng = np.random.default_rng(t)
        x = torch.from_numpy((rng.random((1, t, 128)) < 0.1).astype(np.float32))
        cond = torch.from_numpy(rng.random((1, t, 1025), dtype=np.float32))
        out = tsh.whole_clip_forward(model, x, cond, x)
        assert out.shape == (1, tsh.time_sharded_output_length(t), 1025)
        assert torch.isfinite(out).all()

    def test_too_short_clip_raises(self, state):
        model = S.build_model(TINY, state, "cpu")
        x = torch.zeros((1, 15, 128))
        with pytest.raises(ValueError, match="shorter"):
            tsh.whole_clip_forward(model, x, torch.zeros((1, 15, 1025)), x)

    def test_lengths_match_the_jax_shape_math(self):
        from ml_music_style_transfer_tpu.parallel import time_shard as jtsh
        for t in (16, 17, 516, 860, 1377, 5143, 30960):
            assert tsh.time_sharded_output_length(t) == jtsh.time_sharded_output_length(t)
            for n in (1, 2, 8):
                assert tsh.padded_length(t, n) == jtsh.padded_length(t, n)

    def test_device_resident_synthesis_matches_host_contract(self, clips, state):
        """As tests/test_inference.py:604-646: the wave equals Griffin-Lim on
        the host-contract spectrogram with the same bucketing, and no
        spectrogram-sized tensor crosses."""
        midi, wav = clips["a"]
        synth = _synth(midi, wav, state)
        roll, onoff, cond, t_total = synth.process_whole_clip(midi, wav)
        want_spec = synth.predict_spectrogram_whole_clip(roll, onoff, cond, t_total)
        log = []
        S.TRANSFER_LOG = log
        try:
            got = synth.synthesize_whole_clip(n_iter=3)
        finally:
            S.TRANSFER_LOG = None
        t_out = want_spec.shape[0]
        assert np.all(np.isfinite(got)) and len(got) == t_out * 256
        spec_bytes = t_total * 1025 * 4
        assert log and all(nbytes < 0.6 * spec_bytes for _, nbytes in log), log
        t_gl = -(-t_out // 430) * 430
        want = tgl.griffinlim_from_log_power(
            np.pad(want_spec, ((0, t_gl - t_out), (0, 0))).T,
            generator=torch.Generator().manual_seed(0), n_iter=3, device="cpu").numpy()
        np.testing.assert_allclose(got, want[: t_out * 256], atol=2e-4, rtol=1e-3)


class TestMultiDeviceArguments:
    def test_each_raises_naming_item_9(self, clips, state):
        """Item 9 has landed: each multi-device argument runs. On a mesh of
        this process's one rank (gloo) every path gives one device's
        result; a mesh the launch has no ranks for raises."""
        import torch.distributed as dist
        from ml_music_style_transfer_tpu_torch.parallel import mesh as pmesh

        midi, wav = clips["short"]
        synth = _synth(midi, wav, state)
        with pytest.raises(ValueError, match="needs 2 ranks, the launch has 1"):
            pmesh.make_mesh(2, 1, device="cpu")
        assert not dist.is_initialized()
        want = synth.synthesize_whole_clip(n_iter=1)
        np.testing.assert_array_equal(synth.synthesize_whole_clip(n_iter=1, shard_gl=True), want)
        mesh = pmesh.make_mesh(1, 1, device="cpu")
        try:
            got = synth.synthesize_whole_clip(n_iter=1, mesh=mesh, axis_name="data",
                                              shard_gl=True)
            np.testing.assert_array_equal(got, synth.synthesize_whole_clip(
                n_iter=1, mesh=mesh, axis_name="data", shard_gl=False))
            assert got.shape == want.shape and np.all(np.isfinite(got))
            roll = np.zeros((100, 128), np.float32)
            cond = np.random.default_rng(0).random((100, 1025)).astype(np.float32)
            np.testing.assert_allclose(
                synth.predict_spectrogram_whole_clip(roll, roll, cond, 100, mesh=mesh,
                                                     axis_name="data"),
                synth.predict_spectrogram_whole_clip(roll, roll, cond, 100),
                atol=2e-3, rtol=1e-3)
            specs = np.random.default_rng(1).random((2, 1025, 30)).astype(np.float32)
            np.testing.assert_array_equal(
                bulk.bulk_griffinlim(specs, [0, 1], mesh=mesh, n_iter=1).numpy(),
                bulk.bulk_griffinlim(specs, [0, 1], n_iter=1, device="cpu").numpy())
            wavs, errors = bulk.batch_synthesize_waveforms([synth], n_iter=1, mesh=mesh)
            assert errors == [None]
            np.testing.assert_array_equal(wavs[0], synth.synthesize_waveform(n_iter=1))
        finally:
            dist.destroy_process_group()


class TestBatch:
    def test_batch_equals_single_requests_bit_for_bit(self, clips, state):
        s1 = _synth(*clips["a"], state)
        s2 = _synth(*clips["b"], state)
        s_bad = _synth("/nonexistent.mid", clips["a"][1], state)
        s3 = _synth(*clips["a"], state)  # the same request twice in one batch
        wavs, errors = bulk.batch_synthesize_waveforms([s1, s_bad, s2, s3], n_iter=3)
        assert errors[0] is None and errors[2] is None and errors[3] is None
        assert errors[1] is not None and wavs[1] is None
        for w, s in ((wavs[0], s1), (wavs[2], s2), (wavs[3], s3)):
            np.testing.assert_array_equal(w, s.synthesize_waveform(n_iter=3))

    def test_batch_seeds_pick_each_clips_phase(self, clips, state):
        s1, s2 = _synth(*clips["a"], state), _synth(*clips["a"], state)
        wavs, errors = bulk.batch_synthesize_waveforms([s1, s2], n_iter=2, seeds=[0, 5])
        assert errors == [None, None]
        np.testing.assert_array_equal(wavs[0], s1.synthesize_waveform(n_iter=2))
        assert not np.array_equal(wavs[0], wavs[1])

    def test_a_failed_fetch_fails_its_item_alone(self, clips, state):
        class Broken:
            def synthesize_waveform_async(self, **kw):
                def fetch():
                    raise RuntimeError("lost on the card")
                return fetch

        s1 = _synth(*clips["short"], state)
        wavs, errors = bulk.batch_synthesize_waveforms([Broken(), s1], n_iter=1)
        assert wavs[0] is None and "lost on the card" in errors[0]
        assert errors[1] is None
        np.testing.assert_array_equal(wavs[1], s1.synthesize_waveform(n_iter=1))

    def test_bulk_griffinlim_equals_single_clips_by_seed(self):
        rng = np.random.default_rng(0)
        specs = (rng.random((2, 1025, 64)) * 6).astype(np.float32)
        got = bulk.bulk_griffinlim(specs, [0, 7], n_iter=2, device="cpu")
        for spec, seed, g in zip(specs, (0, 7), got):
            want = tgl.griffinlim_from_log_power(
                torch.from_numpy(spec), generator=torch.Generator().manual_seed(seed),
                n_iter=2, device="cpu")
            assert torch.equal(g, want)
        with pytest.raises(ValueError, match="seeds"):
            bulk.bulk_griffinlim(specs, [0], n_iter=1, device="cpu")

    def test_bulk_synthesize_runs_forward_and_griffinlim(self, state):
        rng = np.random.default_rng(1)
        roll = (rng.random((2, 860, 128)) < 0.05).astype(np.float32)
        cond = rng.random((2, 860, 1025), dtype=np.float32)
        out = bulk.bulk_synthesize(TINY, state, roll, roll, cond, n_iter=1, device="cpu")
        assert out.shape == (2, 256 * 859) and torch.isfinite(out).all()


class TestWarmCache:
    def _exp(self, tmp_path, state, epoch=1):
        ckpt.save_checkpoint(str(tmp_path), epoch, {"params": dict(state)})
        return ckpt.checkpoint_path(str(tmp_path), epoch)

    def test_same_checkpoint_shares_one_model_and_reads_once(self, tmp_path, state, clips,
                                                             monkeypatch):
        path = self._exp(tmp_path, state)
        reads = []
        real = ckpt.restore_checkpoint
        monkeypatch.setattr(ckpt, "restore_checkpoint", lambda p, **kw: reads.append(p) or real(p, **kw))
        midi, wav = clips["a"]
        a = S.AudioSynthesizer(str(tmp_path), midi, wav, model_cfg=TINY, checkpoint_path=path,
                               device="cpu")
        b = S.AudioSynthesizer(str(tmp_path), *clips["b"], model_cfg=TINY, checkpoint_path=path,
                               device="cpu")
        assert a.model is b.model and len(reads) == 1
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))  # a re-save
        c = S.AudioSynthesizer(str(tmp_path), midi, wav, model_cfg=TINY, checkpoint_path=path,
                               device="cpu")
        assert c.model is not a.model and len(reads) == 2

    def test_cap_of_two_evicts_the_oldest(self, tmp_path, state, clips, caplog):
        paths = [self._exp(tmp_path, state, epoch=e) for e in (1, 2, 3)]
        midi, wav = clips["a"]
        models = [S.AudioSynthesizer(str(tmp_path), midi, wav, model_cfg=TINY, checkpoint_path=p,
                                     device="cpu").model for p in paths]
        assert len(S._PARAMS_CACHE) == 2
        assert "evicted" in caplog.text
        again = S.AudioSynthesizer(str(tmp_path), midi, wav, model_cfg=TINY,
                                   checkpoint_path=paths[2], device="cpu").model
        assert again is models[2]
        first = S.AudioSynthesizer(str(tmp_path), midi, wav, model_cfg=TINY,
                                   checkpoint_path=paths[0], device="cpu").model
        assert first is not models[0]

    def test_concurrent_misses_build_once(self):
        """The daemon's two threads may miss on one key together: one
        build, and both get its model."""
        builds, got = [], []
        start = threading.Barrier(2)

        def build():
            builds.append(1)
            time.sleep(0.2)
            return object()

        def worker():
            start.wait()
            got.append(S._cached_model(("k",), None, build))

        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(builds) == 1 and got[0] is got[1]

    def test_in_memory_params_are_identity_checked(self, state, clips):
        midi, wav = clips["a"]
        a = _synth(midi, wav, state)
        assert _synth(midi, wav, state).model is a.model
        copy = dict(state)  # equal contents, another object
        assert _synth(midi, wav, copy).model is not a.model
        # a stale entry whose id() is reused by a new object is not served
        key = ("inmem", id(copy), TINY, "cpu")
        S._PARAMS_CACHE.put(key, (object(), a.model))
        assert _synth(midi, wav, copy).model is not a.model

    def test_reference_tar_forces_compat_and_the_cache_keeps_the_config(self, tmp_path,
                                                                         flax_params, clips):
        path = str(tmp_path / "checkpoint-2.tar")
        save_reference_checkpoint(path, flax_params, epoch=2)
        midi, wav = clips["a"]
        a = S.AudioSynthesizer(str(tmp_path), midi, wav, model_cfg=TINY, checkpoint_path=path,
                               device="cpu")
        b = S.AudioSynthesizer(str(tmp_path), midi, wav, model_cfg=TINY, checkpoint_path=path,
                               device="cpu")
        assert a.model is b.model
        assert a.model_cfg.compat_mbr_noop and b.model_cfg.compat_mbr_noop
        assert a.model.cfg.compat_mbr_noop


class TestTransferSeams:
    def test_tiled_serving_moves_no_spectrogram(self, clips, state):
        midi, wav = clips["a"]
        synth = _synth(midi, wav, state)
        log = []
        S.TRANSFER_LOG = log
        try:
            y = synth.synthesize_waveform(n_iter=1)
        finally:
            S.TRANSFER_LOG = None
        _, _, _, t_total = synth._chunk_midi(midi, overlap=True)
        assert {d for d, _ in log} == {"h2d", "d2h"}
        assert all(n < 0.6 * t_total * 1025 * 4 for _, n in log), log
        assert ("d2h", y.nbytes) in log

    def test_async_returns_a_fetch_equal_to_the_sync_result(self, clips, state):
        synth = _synth(*clips["short"], state)
        fetch = synth.synthesize_waveform_async(n_iter=2)
        np.testing.assert_array_equal(fetch(), synth.synthesize_waveform(n_iter=2))


def _responses(out_s):
    return [json.loads(line) for line in out_s.getvalue().splitlines()]


class TestServeDaemon:
    def test_serve_loop_handles_requests_and_errors(self, clips, state, tmp_path):
        midi, wav = clips["a"]
        made = []

        def make_synth(m, a):
            s = _synth(m, a, state)
            made.append(s)
            return s

        reqs = [
            {"midi": midi, "audio": wav, "out": str(tmp_path / "a.wav"), "n_iter": 2},
            {"midi": "/nonexistent.mid", "audio": wav, "out": str(tmp_path / "b.wav"), "n_iter": 2},
            {"midi": midi, "audio": wav, "out": str(tmp_path / "c.wav"), "n_iter": 2,
             "cond_mode": "center"},
        ]
        out_s = io.StringIO()
        served = serve.serve_loop(make_synth, io.StringIO(
            "\n".join(json.dumps(r) for r in reqs) + "\nquit\n"), out_s)
        resps = _responses(out_s)
        assert served == 2
        assert resps[0]["ok"] and os.path.exists(resps[0]["out"])
        assert not resps[1]["ok"] and "error" in resps[1]
        assert resps[2]["ok"] and os.path.exists(resps[2]["out"])
        assert all(s.model is made[0].model for s in made)  # warm cache

    def test_serve_loop_pipelines_host_under_device(self, tmp_path):
        """With H s of host work and D s of device work per request, depth 2
        finishes k requests in about H + k max(H, D), not k (H + D); depth 0
        is serial. A fake synthesizer keeps the timing deterministic."""
        H = D = 0.05
        k = 6

        class FakeSynth:
            hp = types.SimpleNamespace(sr=100)

            def synthesize_waveform_async(self, n_iter=300, overlap=True, cond_mode="aligned"):
                time.sleep(H)
                ready = time.monotonic() + D

                def fetch():
                    delay = ready - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    return np.zeros(16, np.float32)

                return fetch

        reqs = [{"midi": "m.mid", "audio": "a.wav", "out": str(tmp_path / f"p{i}.wav")}
                for i in range(k)]
        payload = "\n".join(json.dumps(r) for r in reqs) + "\n"
        out_s = io.StringIO()
        t0 = time.perf_counter()
        served = serve.serve_loop(lambda m, a: FakeSynth(), io.StringIO(payload), out_s)
        wall = time.perf_counter() - t0
        assert served == k
        resps = _responses(out_s)
        assert all(r["ok"] for r in resps)
        assert [r["out"] for r in resps] == [r["out"] for r in reqs]  # in order
        serial = k * (H + D)
        assert wall < 0.75 * serial, (wall, serial)
        t1 = time.perf_counter()
        served = serve.serve_loop(lambda m, a: FakeSynth(), io.StringIO(payload), io.StringIO(),
                                  pipeline_depth=0)
        wall0 = time.perf_counter() - t1
        assert served == k
        assert wall0 > 0.9 * serial, (wall0, serial)

    def test_serve_loop_batch_protocol(self, clips, state, tmp_path):
        midi, wav = clips["a"]

        def make_synth(m, a):
            if not os.path.exists(m):
                raise FileNotFoundError(m)  # construction-time isolation
            return _synth(m, a, state)

        req = {"batch": [
            {"midi": midi, "audio": wav, "out": str(tmp_path / "a.wav")},
            {"midi": "/nonexistent.mid", "audio": wav, "out": str(tmp_path / "b.wav")},
            {"midi": midi, "audio": wav, "out": str(tmp_path / "c.wav")},
        ], "n_iter": 2}
        out_s = io.StringIO()
        served = serve.serve_loop(make_synth, io.StringIO(json.dumps(req) + "\nquit\n"), out_s)
        assert served == 2
        (resp,) = _responses(out_s)
        assert resp["ok"] and len(resp["batch"]) == 3
        assert resp["batch"][0]["ok"] and os.path.exists(resp["batch"][0]["out"])
        assert not resp["batch"][1]["ok"] and "error" in resp["batch"][1]
        assert resp["batch"][2]["ok"] and os.path.exists(resp["batch"][2]["out"])

    def test_serve_loop_whole_clip_request(self, clips, state, tmp_path):
        midi, wav = clips["short"]
        reqs = [{"midi": midi, "audio": wav, "out": str(tmp_path / "w.wav"), "n_iter": 2,
                 "whole_clip": True},
                {"midi": midi, "audio": wav, "out": str(tmp_path / "x.wav"), "n_iter": 2,
                 "whole_clip": True, "shard_gl": True}]
        out_s = io.StringIO()
        served = serve.serve_loop(lambda m, a: _synth(m, a, state), io.StringIO(
            "\n".join(json.dumps(r) for r in reqs) + "\n"), out_s)
        ok, sharded = _responses(out_s)
        assert served == 2 and ok["ok"] and sharded["ok"]
        y, sr = audio_io.read_wav(ok["out"], sr=None)
        want = _synth(midi, wav, state).synthesize_whole_clip(n_iter=2)
        assert sr == 44100 and len(y) == len(want)
        # item 9 landed: with one device "shard_gl" changes nothing
        np.testing.assert_array_equal(audio_io.read_wav(sharded["out"], sr=None)[0], y)

    def test_main_serves_stdin_on_the_cpu(self, tmp_path, state, clips, monkeypatch, capsys):
        exp = tmp_path / "experiments" / "e"
        exp.mkdir(parents=True)
        ckpt.save_checkpoint(str(exp), 1, {"params": dict(state)})
        es = ckpt.ExperimentState(1, 1, "e")
        es.best_epoch = 1
        es.save(str(exp))
        midi, wav = clips["short"]
        reqs = [{"midi": midi, "audio": wav, "out": str(tmp_path / f"o{i}.wav"), "n_iter": 1}
                for i in range(2)]
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n"))
        n = serve.main(["-exp-name", "e", "--exp-root", str(tmp_path / "experiments"),
                        "--width-mult", str(1 / 16), "--device", "cpu"])
        resps = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert n == 2 and [r["ok"] for r in resps] == [True, True]
        assert all(os.path.exists(r["out"]) for r in resps)

    def test_warmup_runs_each_path(self, state, capsys):
        calls = []

        def make_synth(m, a):
            calls.append(m)
            return _synth(m, a, state)

        serve.warmup(make_synth, [2.0], n_iter=1, whole_clip=True)
        assert len(calls) == 2  # the single request and the batch's second item
        assert "warmup 2.0s" in capsys.readouterr().err

    @pytest.mark.parametrize("flag, item", [(["--mesh-data", "2"], "item 9"),
                                            (["--use-ema"], None)])
    def test_main_refuses_what_is_not_ported(self, flag, item, monkeypatch):
        """--mesh-data > 1 (item 9) has landed: it serves over the launch's
        ranks, so a launch of one rank refuses 2 (the multi-rank daemon is
        in test_torch_port_gl_shard.py). --use-ema (item 7) is ported: the
        daemon starts with it and stops at 'quit' (serving EMA weights is in
        test_torch_port_msgpack.py)."""
        if item is None:
            monkeypatch.setattr(sys, "stdin", io.StringIO("quit\n"))
            assert serve.main(["-exp-name", "e", "--device", "cpu", *flag]) == 0
            return
        with pytest.raises(ValueError, match="needs 2 ranks, the launch has 1"):
            serve.main(["-exp-name", "e", "--device", "cpu", *flag])


class TestDeviceContract:
    """With no card the new entry points raise unless asked for the CPU."""

    @pytest.fixture(autouse=True)
    def _no_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works here")

    def test_serve_main_default_device_raises(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["-exp-name", "e"])

    def test_bulk_griffinlim_default_device_raises(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bulk.bulk_griffinlim(np.zeros((1, 1025, 30), np.float32), [0], n_iter=1)

    def test_bench_inference_default_device_raises(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_inference.main([])

    def test_bench_inference_runs_on_the_cpu_when_asked(self, capsys, tmp_path):
        # the one-pass probe (up to 960 s of audio by default) is held in
        # test_torch_port_bench_scripts.py at a 60 s cap
        metrics = bench_inference.main(
            ["--width-mult", str(1 / 16), "--n-iter", "1", "--daemon-requests", "2",
             "--seconds", "4", "--device", "cpu", "--probe-cap-seconds", "0",
             "--out-dir", str(tmp_path)])
        assert set(metrics) == {
            "serving_s_per_30s_clip", "griffinlim_s_per_10s_clip", "whole_clip_s_per_30s_clip",
            "daemon_requests_per_s_serial", "daemon_requests_per_s_pipelined",
            "batch_griffinlim_s_per_clip"}
        assert "device='cpu'" in capsys.readouterr().out
