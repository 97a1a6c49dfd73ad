"""The port's data path against the JAX package on the CPU: chunk math,
the piano-roll ops, the NumPy DSP references, synthetic dataset
directories, preprocessing into HDF5 (and into memory), cross-reading of
each package's files, and the MusicNet curation. The same numpy-seeded
inputs go through both packages; tolerances are stated per test."""
import filecmp
import os

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_music_style_transfer_tpu.data import chunking as jchunking
from ml_music_style_transfer_tpu.data import musicnet as jmusicnet
from ml_music_style_transfer_tpu.data import preprocess as jpp
from ml_music_style_transfer_tpu.data.hdf5_store import load_dataset as jload
from ml_music_style_transfer_tpu.ops import pianoroll as jroll
from ml_music_style_transfer_tpu.ops import reference as jref
from ml_music_style_transfer_tpu.testing import synthetic as jsynth
from ml_music_style_transfer_tpu_torch import config
from ml_music_style_transfer_tpu_torch.data import chunking, musicnet
from ml_music_style_transfer_tpu_torch.data import preprocess as pp
from ml_music_style_transfer_tpu_torch.data.dataset import ChunkDataset
from ml_music_style_transfer_tpu_torch.data.hdf5_store import ArrayStore, H5Store, load_dataset
from ml_music_style_transfer_tpu_torch.ops import pianoroll as roll_ops
from ml_music_style_transfer_tpu_torch.ops import reference as ref
from ml_music_style_transfer_tpu_torch.testing import synthetic

STYLES = ["cuba", "upright"]
SONGS = [101, 202]
# the device STFT backend: float32 FFTs (jnp against torch.fft) of one
# chunk, log1p(|S|^2) in log space; both sit within ~2e-6 of each other and
# within ~2e-4 of the float64 host reference (JAX preprocess.py:176)
DEVICE_SPEC_ATOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Six test workers share the machine: two torch threads per module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def song_dirs(tmp_path_factory):
    """One synthetic dataset directory per package, from one seed."""
    root = tmp_path_factory.mktemp("songs")
    kw = dict(song_ids=SONGS, styles=STYLES, duration=12.0, seed=3, normalize="rms")
    jsynth.make_dataset_dir(str(root / "jax"), **kw)
    synthetic.make_dataset_dir(str(root / "port"), **kw)
    return str(root / "jax"), str(root / "port")


@pytest.fixture(scope="module")
def files(song_dirs, tmp_path_factory):
    """The JAX directory preprocessed by both packages with each STFT
    backend, audio stored: {(package, backend): path}."""
    root = tmp_path_factory.mktemp("h5")
    src = song_dirs[0]
    out = {}
    for backend in ("host", "device"):
        kw = dict(song_ids=SONGS, styles=STYLES, store_audio=True, stft_backend=backend)
        out["jax", backend] = jpp.get_data(src, str(root / f"j_{backend}"), "train", **kw)
        out["port", backend] = pp.get_data(src, str(root / f"p_{backend}"), "train",
                                           device="cpu", **kw)
    return out


class TestChunking:
    @pytest.mark.parametrize("roll_len", [500, 860, 860 + 512 * 10, 5160, 10320, 860 + 512 * 200])
    @pytest.mark.parametrize("max_chunks", [100, 5])
    def test_num_song_chunks_matches_jax(self, roll_len, max_chunks):
        assert (chunking.num_song_chunks(roll_len, max_chunks=max_chunks)
                == jchunking.num_song_chunks(roll_len, max_chunks=max_chunks))

    @pytest.mark.parametrize("n_chunks", [0, 1, 3])
    def test_chunk_audio_and_pianoroll_equal_jax(self, n_chunks):
        rng = np.random.default_rng(n_chunks)
        audio = rng.standard_normal(2 * 131072 + 219904 - 5000).astype(np.float32)  # padded tail
        roll = rng.random((860 + 512 * 2 - 30, 128)).astype(np.float32)
        np.testing.assert_array_equal(chunking.chunk_audio(audio, n_chunks),
                                      jchunking.chunk_audio(audio, n_chunks))
        np.testing.assert_array_equal(chunking.chunk_pianoroll(roll, n_chunks),
                                      jchunking.chunk_pianoroll(roll, n_chunks))

    def test_config_constants_equal_jax(self):
        from ml_music_style_transfer_tpu import config as jconfig

        assert dict(config.PIANO_SCORES) == dict(jconfig.PIANO_SCORES)
        assert config.STYLES == jconfig.STYLES


class TestPianorollOps:
    """Bit-equal to the JAX package's jitted ops."""

    def test_binarize_and_onset_offset(self):
        rng = np.random.default_rng(0)
        roll = (rng.random((3, 200, 128)) < 0.1) * rng.integers(1, 128, (3, 200, 128))
        roll = roll.astype(np.float32)
        got = roll_ops.binarize(torch.from_numpy(roll)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jroll.binarize(jnp.asarray(roll))))
        want = np.asarray(jroll.onset_offset(jnp.asarray(got)))
        np.testing.assert_array_equal(roll_ops.onset_offset(torch.from_numpy(got)).numpy(), want)
        assert set(np.unique(want)) <= {-1.0, 0.0, 1.0}

    def test_notes_to_pianoroll(self):
        rng = np.random.default_rng(1)
        n = 40
        pitches = rng.integers(0, 128, n).astype(np.int32)
        vel = rng.integers(0, 128, n).astype(np.float32)
        vel[-5:] = 0  # padded slots
        starts = rng.uniform(0, 4, n).astype(np.float32)
        ends = (starts + rng.uniform(0.05, 1.0, n)).astype(np.float32)
        want = np.asarray(jroll.notes_to_pianoroll(
            jnp.asarray(pitches), jnp.asarray(vel), jnp.asarray(starts), jnp.asarray(ends),
            fs=172, length=900))
        got = roll_ops.notes_to_pianoroll(*map(torch.from_numpy, (pitches, vel, starts, ends)),
                                          fs=172, length=900).numpy()
        np.testing.assert_array_equal(got, want)


class TestReferenceDSP:
    """Both are NumPy in float64: bit-equal."""

    def test_stft_istft_log_power_equal_jax(self):
        y = np.random.default_rng(2).standard_normal(20000)
        S = ref.stft(y, 2048, 256)
        np.testing.assert_array_equal(S, jref.stft(y, 2048, 256))
        np.testing.assert_array_equal(ref.frame(y, 2048, 256), jref.frame(y, 2048, 256))
        np.testing.assert_array_equal(ref.istft(S, 256, length=len(y)),
                                      jref.istft(S, 256, length=len(y)))
        lp = ref.log_power(S)
        np.testing.assert_array_equal(lp, jref.log_power(S))
        np.testing.assert_array_equal(ref.inverse_log_power(lp), jref.inverse_log_power(lp))

    def test_griffinlim_equal_jax(self):
        mag = np.abs(ref.stft(np.random.default_rng(3).standard_normal(8000), 2048, 256))
        np.testing.assert_array_equal(ref.griffinlim(mag, n_iter=4, seed=1),
                                      jref.griffinlim(mag, n_iter=4, seed=1))


class TestSynthetic:
    def test_make_dataset_dir_byte_equal_to_jax(self, song_dirs):
        jdir, pdir = song_dirs
        names = sorted(os.listdir(jdir))
        assert names == sorted(os.listdir(pdir)) and len(names) == len(SONGS) * (1 + len(STYLES))
        for name in names:
            assert filecmp.cmp(os.path.join(jdir, name), os.path.join(pdir, name), shallow=False)


class TestPreprocess:
    @pytest.mark.parametrize("backend", ["host", "device"])
    def test_arrays_equal_jax(self, files, backend):
        """Rolls, onoff and audio exact; host spectrograms exact (both the
        NumPy reference); device spectrograms within DEVICE_SPEC_ATOL."""
        a = jload(files["jax", backend])
        b = load_dataset(files["port", backend])
        assert sorted(a) == sorted(b) == sorted(
            ["pianoroll", "onoff"] + [f"{p}_{s}" for p in ("spec", "audio") for s in STYLES])
        for k in a:
            assert a[k].shape == b[k].shape and b[k].dtype == np.float32, k
            if k.startswith("spec_") and backend == "device":
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=DEVICE_SPEC_ATOL)
            else:
                np.testing.assert_array_equal(b[k], a[k])
        assert a["pianoroll"].shape[1:] == (860, 128) and a["spec_cuba"].shape[1:] == (1025, 860)

    def test_each_package_reads_the_others_file(self, files):
        for writer, reader in (("jax", load_dataset), ("port", jload)):
            for include_audio in (True, False):
                got = reader(files[writer, "host"], include_audio=include_audio)
                want = jload(files["jax", "host"], include_audio=include_audio)
                assert sorted(got) == sorted(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
        port_ds = ChunkDataset(files["jax", "host"], seed=0)
        assert port_ds.styles == [f"spec_{s}" for s in STYLES]

    def test_file_layout_is_the_jax_packages(self, files):
        """Same keys, dtypes and resizable chunked datasets."""
        with h5py.File(files["jax", "host"], "r") as fj, h5py.File(files["port", "host"], "r") as fp:
            assert sorted(fj) == sorted(fp)
            for k in fj:
                assert fp[k].dtype == fj[k].dtype and fp[k].maxshape == fj[k].maxshape
                assert fp[k].maxshape[0] is None and fp[k].chunks is not None

    def test_load_options(self, files):
        d = load_dataset(files["port", "host"], n_read=2, include_specs=False, dtype="float64")
        assert sorted(d) == sorted(["pianoroll", "onoff"] + [f"audio_{s}" for s in STYLES])
        assert all(v.shape[0] == 2 and v.dtype == np.float64 for v in d.values())

    def test_get_arrays_equals_the_file(self, song_dirs, files):
        got = pp.get_arrays(song_dirs[0], "train", song_ids=SONGS, styles=STYLES,
                            store_audio=True, stft_backend="host", prefetch=False, device="cpu")
        want = load_dataset(files["port", "host"])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    def test_skip_spectrum_and_missing_style(self, song_dirs):
        d = pp.get_arrays(song_dirs[1], "train", song_ids=[101], styles=["cuba", "harpsichord"],
                          store_audio=True, write_spectrum=False, device="cpu")
        assert sorted(d) == ["audio_cuba", "onoff", "pianoroll"]  # harpsichord skipped
        with pytest.raises(ValueError, match="store_audio"):
            pp.get_arrays(song_dirs[1], "train", song_ids=[101], write_spectrum=False,
                          device="cpu")

    def test_array_store_appends_like_h5store(self, tmp_path):
        rng = np.random.default_rng(4)
        parts = [(rng.random((n, 860, 128)), rng.random((n, 1025, 860))) for n in (3, 2)]
        mem = ArrayStore()
        with h5py.File(tmp_path / "d.hdf5", "w") as f:
            disk = H5Store(f)
            for store in (mem, disk):
                for roll, spec in parts:
                    store.write_pianoroll(roll, roll)
                    store.write_spectrum(spec, "cuba")
        want = load_dataset(str(tmp_path / "d.hdf5"))
        got = mem.arrays()
        assert sorted(got) == sorted(want) and got["spec_cuba"].shape == (5, 1025, 860)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    def test_debug_dumps(self, song_dirs, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        pp.get_arrays(song_dirs[1], "train", song_ids=[101], styles=["cuba"], debug=True,
                      max_chunks=2, stft_backend="host", device="cpu")
        names = os.listdir("debugdir")
        assert sum(n.endswith(".wav") for n in names) == 2
        assert sum(n.endswith(".mid") for n in names) == 2

    def test_discovery_and_backend_rule_match_jax(self, song_dirs):
        assert pp.discover_song_ids(song_dirs[1]) == jpp.discover_song_ids(song_dirs[1]) == SONGS
        assert pp.discover_styles(song_dirs[1]) == jpp.discover_styles(song_dirs[1]) == STYLES
        for bw, host_s in ((0.05, 0.05), (10.0, 0.05), (0.2, 0.05), (0.05, 0.5)):
            assert pp._auto_choice(bw, host_s) == jpp._auto_choice(bw, host_s)
        assert pp.resolve_stft_backend("auto", device="cpu") == "device"
        assert pp.resolve_stft_backend("host") == "host"
        with pytest.raises(ValueError, match="backend"):
            pp.resolve_stft_backend("gpu")
        assert pp.str2bool("yes") and not pp.str2bool("0")

    def test_device_backend_and_cli_need_a_card_unless_asked(self, song_dirs, tmp_path):
        chunks = np.zeros((1, 219904), np.float32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pp.spectrograms_from_chunks(chunks)
        out = pp.cli(["-data-dir", song_dirs[1], "-dataset-outpath", str(tmp_path / "c"),
                      "--song-ids", "202", "--store-audio", "true", "--skip-spectrum", "true",
                      "--device", "cpu"])
        assert sorted(load_dataset(out)) == sorted(["pianoroll", "onoff", "audio_cuba",
                                                    "audio_upright"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pp.cli(["-data-dir", song_dirs[1], "-dataset-outpath", str(tmp_path / "d"),
                    "--song-ids", "202"])


class TestMusicNet:
    def test_extract_piano_pieces_matches_jax(self, tmp_path, monkeypatch):
        labels = tmp_path / "mn" / "train_labels"
        labels.mkdir(parents=True)
        for song, instruments in (("1759", [1, 1]), ("2106", [1, 41]), ("2303", [1]),
                                  ("1788", [7, 7])):
            rows = "".join(f"{i * 100},{i * 100 + 50},{ins},0,60,1.0,0.5,q\n"
                           for i, ins in enumerate(instruments))
            (labels / f"{song}.csv").write_text(
                "start_time,end_time,instrument,note,start_beat,end_beat,note_value,x\n" + rows)
        monkeypatch.chdir(tmp_path)
        want = jmusicnet.extract_piano_pieces(str(tmp_path / "mn"), "train", "jax")
        got = musicnet.main([str(tmp_path / "mn"), "--output-file-basename", "port"])
        assert got == want == ["1759", "2303"]
        assert (tmp_path / "port_train.txt").read_text() == (tmp_path / "jax_train.txt").read_text()
