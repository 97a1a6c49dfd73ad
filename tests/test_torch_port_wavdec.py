"""The port's WAV reading (``data/audio_io.py``, ``csrc/wavdec.cpp``) on the
CPU: the port's copy of tests/test_wav_fuzz.py, run over both of its
decoders (the native library, the default, and scipy), and a parity class
that holds the port's native decoder to the JAX package's native and numpy
decoders on every format, the channel mixdown and the resampler, within
1e-6 (wavdec.cpp:17-18: float64 resampling, like scipy's).

Contract: any byte string either reads as finite mono audio or raises
ValueError, never a raw parser error; a missing file raises
FileNotFoundError. The native decoder raises when its library cannot be
built: it never falls back to scipy.
"""
import struct
import threading
import time

import numpy as np
import pytest
from scipy.io import wavfile

from ml_music_style_transfer_tpu.data import audio_io as jaudio
from ml_music_style_transfer_tpu_torch.data import audio_io


@pytest.fixture(params=[False, None], ids=["scipy", "native"])
def native(request):
    return request.param


def _valid_file(tmp_path, n=4096, rate=22050) -> str:
    p = str(tmp_path / "ok.wav")
    t = np.arange(n) / rate
    audio_io.write_wav(p, 0.5 * np.sin(2 * np.pi * 440 * t), rate)
    return p


def _assert_clean(tmp_path, raw: bytes, native_mode):
    p = str(tmp_path / "f.wav")
    with open(p, "wb") as f:
        f.write(raw)
    try:
        y, sr = audio_io.read_wav(p, native=native_mode)
    except ValueError:
        return None
    assert y.dtype == np.float32 and y.ndim == 1
    assert np.all(np.isfinite(y)) and sr > 0
    return y


def test_valid_roundtrip(tmp_path, native):
    p = _valid_file(tmp_path)
    y, sr = audio_io.read_wav(p, sr=44100, native=native)
    assert sr == 44100 and y.size > 0 and np.abs(y).max() < 1.01


def test_every_prefix_is_clean(tmp_path, native):
    with open(_valid_file(tmp_path, n=256), "rb") as f:
        raw = f.read()
    for cut in range(0, len(raw), 7):
        _assert_clean(tmp_path, raw[:cut], native)


def test_random_garbage(tmp_path, native):
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(0, 300))
        _assert_clean(tmp_path, rng.integers(0, 256, n).astype(np.uint8).tobytes(), native)


def test_mutated_header(tmp_path, native):
    with open(_valid_file(tmp_path, n=256), "rb") as f:
        raw = bytearray(f.read())
    rng = np.random.default_rng(1)
    for _ in range(200):
        i = int(rng.integers(0, min(64, len(raw))))
        old = raw[i]
        raw[i] = int(rng.integers(0, 256))
        _assert_clean(tmp_path, bytes(raw), native)
        raw[i] = old


def test_zero_sample_rate(tmp_path, native):
    with open(_valid_file(tmp_path), "rb") as f:
        raw = bytearray(f.read())
    i = raw.index(b"fmt ") + 8 + 4  # fmt chunk: tag(2)+channels(2)+rate(4)
    raw[i:i + 4] = struct.pack("<I", 0)
    p = str(tmp_path / "zr.wav")
    with open(p, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(ValueError):
        audio_io.read_wav(p, native=native)


def test_empty_data_chunk(tmp_path, native):
    p = str(tmp_path / "empty.wav")
    audio_io.write_wav(p, np.zeros((0,), np.float32), 44100)
    with pytest.raises(ValueError, match="no samples"):
        audio_io.read_wav(p, native=native)


def test_absurd_sample_rate_rejected_before_resampler(tmp_path, native):
    """A corrupt rate field raises ValueError instead of asking the
    resampler for a filter of 10 * max(up, down) taps."""
    with open(_valid_file(tmp_path), "rb") as f:
        raw = bytearray(f.read())
    i = raw.index(b"fmt ") + 8 + 4
    for rate in (0xFFFFFFF0, 9_999_991):  # huge; huge prime (gcd 1)
        raw[i:i + 4] = struct.pack("<I", rate)
        p = str(tmp_path / "ar.wav")
        with open(p, "wb") as f:
            f.write(bytes(raw))
        with pytest.raises(ValueError):
            audio_io.read_wav(p, native=native)


def test_nonfinite_float_wav_rejected(tmp_path, native):
    p = str(tmp_path / "nan.wav")
    y = np.zeros(2048, np.float32)
    y[100] = np.nan
    wavfile.write(p, 44100, y)
    with pytest.raises(ValueError, match="non-finite"):
        audio_io.read_wav(p, native=native)


def test_missing_file_stays_file_not_found(tmp_path, native):
    with pytest.raises(FileNotFoundError):
        audio_io.read_wav(str(tmp_path / "nope.wav"), native=native)


def test_native_raises_when_the_library_cannot_be_built(tmp_path, monkeypatch):
    """No quiet fall-back (the JAX package's decoder falls back to scipy):
    the default path raises what the build raised; ``native=False`` still
    reads."""
    from ml_music_style_transfer_tpu_torch.ops.kernels import _build

    p = _valid_file(tmp_path)

    def no_compiler(name):
        raise RuntimeError("no C++ compiler found (set CXX)")

    audio_io._lib.cache_clear()
    monkeypatch.setattr(_build, "load_host", no_compiler)
    try:
        for mode in (None, True):
            with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
                audio_io.read_wav(p, native=mode)
        assert audio_io.read_wav(p, native=False)[1] == 44100
    finally:
        audio_io._lib.cache_clear()


def _pcm24(path, x: np.ndarray, rate: int) -> None:
    """A 24-bit PCM WAV of ``x`` (frames, channels) in [-1, 1] (scipy cannot
    write one)."""
    q = np.clip(np.round(x * (2 ** 23 - 1)), -2 ** 23, 2 ** 23 - 1).astype(np.int32)
    raw = (q.reshape(-1, 1).view(np.uint8).reshape(-1, 4)[:, :3]).tobytes()
    ch = x.shape[1]
    fmt = struct.pack("<HHIIHH", 1, ch, rate, rate * ch * 3, ch * 3, 24)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + \
        struct.pack("<I", len(raw)) + raw + (b"\0" if len(raw) % 2 else b"")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


class TestNativeParity:
    """The port's native decoder against the JAX package's native decoder
    and its numpy (scipy) path: every format, the stereo mixdown, and the
    firwin(kaiser 5.0)/upfirdn resampler, within 1e-6."""

    FORMATS = ["i16", "i24", "i32", "u8", "f32", "f64", "stereo", "stereo24",
               "resamp22k", "resamp48k"]

    def _sig(self, n=44100):
        t = np.arange(n) / 44100.0
        return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)

    def _write(self, p, fmt):
        sig = self._sig()
        st = np.stack([sig, -0.5 * sig], axis=1)
        if fmt == "i16":
            wavfile.write(p, 44100, (sig * 32767).astype(np.int16))
        elif fmt == "i24":
            _pcm24(p, sig[:, None], 44100)
        elif fmt == "i32":
            wavfile.write(p, 44100, (sig * 2 ** 31 * 0.9).astype(np.int32))
        elif fmt == "u8":
            wavfile.write(p, 44100, ((sig * 127) + 128).astype(np.uint8))
        elif fmt == "f32":
            wavfile.write(p, 44100, sig)
        elif fmt == "f64":
            wavfile.write(p, 44100, sig.astype(np.float64))
        elif fmt == "stereo":
            wavfile.write(p, 44100, (st * 32767).astype(np.int16))
        elif fmt == "stereo24":
            _pcm24(p, st, 44100)
        elif fmt == "resamp22k":  # 22.05 kHz -> 44.1 kHz (2/1)
            wavfile.write(p, 22050, (sig[:22050] * 32767).astype(np.int16))
        else:  # 48 kHz -> 44.1 kHz (the 147/160 polyphase)
            wavfile.write(p, 48000, (sig * 32767).astype(np.int16))

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_decode_parity(self, tmp_path, fmt):
        if jaudio._native() is None:
            pytest.fail("the JAX package's native decoder did not build")
        p = str(tmp_path / f"{fmt}.wav")
        self._write(p, fmt)
        got, rate = audio_io.read_wav(p, sr=44100)
        assert rate == 44100 and got.dtype == np.float32
        refs = {"jax_native": jaudio.read_wav(p, sr=44100, native=True),
                "jax_numpy": jaudio.read_wav(p, sr=44100, native=False),
                "port_scipy": audio_io.read_wav(p, sr=44100, native=False)}
        for name, (want, want_rate) in refs.items():
            assert want_rate == 44100 and want.shape == got.shape, name
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
        # the same C source as the JAX package's: bit for bit
        np.testing.assert_array_equal(got, refs["jax_native"][0])

    def test_resampler_matches_scipy_directly(self):
        from scipy.signal import resample_poly

        rng = np.random.default_rng(3)
        x = rng.standard_normal(8192).astype(np.float32)
        for up, down in [(2, 1), (160, 147), (147, 160), (3, 7)]:
            want = resample_poly(x.astype(np.float64), up, down).astype(np.float32)
            got = audio_io.resample_native(x, up, down)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_native_releases_gil_under_concurrent_decode(self, tmp_path):
        """Two threads decoding 30 s files at once take well under twice the
        serial time of the same work, which holds only if the decode does
        not hold the GIL (tests/test_wav_fuzz.py's bound)."""
        sig = np.tile(self._sig(), 30)
        p = str(tmp_path / "big.wav")
        wavfile.write(p, 44100, (sig * 32767).astype(np.int16))
        reps = 4

        def work():
            for _ in range(reps):
                audio_io.read_wav(p, sr=44100)

        t0 = time.perf_counter()
        work()
        serial = time.perf_counter() - t0
        ts = [threading.Thread(target=work) for _ in range(2)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        dual = time.perf_counter() - t0
        assert not any(t.is_alive() for t in ts)
        assert dual < 2.5 * serial + 0.5, (serial, dual)
