"""The port's serving slice as a whole against the JAX package on the CPU:
the same synthetic MIDI/WAV and the same weights (width 1/16, float32) go
through both ``AudioSynthesizer``s; then Griffin-Lim on the predicted
spectrogram from one shared numpy phase. Also the device contract: with no
card the port's entry points raise unless asked for the CPU."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_music_style_transfer_tpu.compat import save_reference_checkpoint
from ml_music_style_transfer_tpu.config import ModelConfig as JModelConfig
from ml_music_style_transfer_tpu.data import audio_io as jaudio
from ml_music_style_transfer_tpu.infer import AudioSynthesizer as JSynth
from ml_music_style_transfer_tpu.midi import writer as jmidi_writer
from ml_music_style_transfer_tpu.models import PerformanceNet as JPerformanceNet
from ml_music_style_transfer_tpu.ops import griffinlim as jgl
from ml_music_style_transfer_tpu.testing import synthetic
from ml_music_style_transfer_tpu_torch.compat import from_jax_params
from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.data import audio_io
from ml_music_style_transfer_tpu_torch.infer import AudioSynthesizer
from ml_music_style_transfer_tpu_torch.infer import cli
from ml_music_style_transfer_tpu_torch.ops import griffinlim as tgl
from ml_music_style_transfer_tpu_torch.ops import stft as tstft

TINY_KW = dict(width_mult=1 / 16, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Tier-1 runs six test workers on one machine; torch's default of one
    thread per core oversubscribes it (a train step here ran 10x slower),
    so this module's torch ops use two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_params():
    model = JPerformanceNet(JModelConfig(**TINY_KW))
    z = jnp.zeros((1, 860, 128))
    params = model.init(jax.random.PRNGKey(0), z, jnp.zeros((1, 860, 1025)), z)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def user_inputs(tmp_path_factory):
    """An 8 s MIDI, its 8 s rendering, and a 3 s timbre clip (shorter than
    the MIDI, so the cyclic conditioning gather runs)."""
    d = tmp_path_factory.mktemp("user")
    rng = np.random.default_rng(11)
    notes = synthetic.random_song(rng, duration=8.0)
    midi = str(d / "user.mid")
    jmidi_writer.save(midi, notes)
    paths = [midi]
    for name, dur in (("long.wav", 8.0), ("short.wav", 3.0)):
        wav = str(d / name)
        jaudio.write_wav(wav, synthetic.render_notes(notes, "harpsichord", 44100, dur), 44100)
        paths.append(wav)
    return paths


def _synths(exp_dir, flax_params, midi, wav):
    jsynth = JSynth(exp_dir, midi, wav, model_cfg=JModelConfig(**TINY_KW), params=flax_params)
    tsynth = AudioSynthesizer(exp_dir, midi, wav, model_cfg=ModelConfig(**TINY_KW),
                              params=from_jax_params(flax_params), device="cpu")
    return jsynth, tsynth


class TestSliceParity:
    @pytest.mark.parametrize("cond_mode", ["aligned", "center"])
    @pytest.mark.parametrize("wav_name", ["long", "short"])
    def test_predicted_spectrogram_matches_jax(self, tmp_path, flax_params, user_inputs,
                                                cond_mode, wav_name):
        midi, long_wav, short_wav = user_inputs
        wav = long_wav if wav_name == "long" else short_wav
        jsynth, tsynth = _synths(str(tmp_path), flax_params, midi, wav)
        want, jt = jsynth._predict_device(midi, wav, cond_mode=cond_mode)
        got, tt = tsynth._predict_device(midi, wav, cond_mode=cond_mode)
        want = np.asarray(want)
        assert jt == tt and got.shape == want.shape
        # float32 through ~30 layers: see tests/test_torch_port_model.py
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())

    def test_griffinlim_on_predicted_spectrogram_from_shared_phase(
            self, tmp_path, flax_params, user_inputs):
        midi, wav, _ = user_inputs
        jsynth, _ = _synths(str(tmp_path), flax_params, midi, wav)
        spec, t_total = jsynth._predict_device(midi, wav)
        t_gl = -(-t_total // 430) * 430
        mag = np.asarray(jnp.sqrt(jnp.expm1(jnp.clip(spec[:t_gl].T, 0.0, 20.0))))
        phase = (2 * np.pi * np.random.default_rng(5).random(mag.shape)).astype(np.float32)
        want = np.asarray(jgl.griffinlim(jnp.asarray(mag), n_iter=8, init_phase=jnp.asarray(phase),
                                         use_pallas_glue=False, transform="fft"))
        got = tgl.griffinlim(mag, n_iter=8, init_phase=phase, device="cpu").numpy()
        # 8 iterations of float32 FFTs: 1e-3 of the waveform's peak
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())

    def test_host_contract_matches_device_path(self, tmp_path, flax_params, user_inputs):
        midi, wav, _ = user_inputs
        _, tsynth = _synths(str(tmp_path), flax_params, midi, wav)
        for mode in ("aligned", "center"):
            chunks = tsynth.process_custom_midi_and_audio(midi, wav, cond_mode=mode)
            want = tsynth.predict_spectrogram(*chunks)
            got, t_total = tsynth._predict_device(midi, wav, cond_mode=mode)
            np.testing.assert_allclose(got.numpy()[:t_total], want, atol=1e-5, err_msg=mode)


class TestServingPath:
    def test_inference_writes_the_waveform(self, tmp_path, flax_params, user_inputs):
        midi, _, short_wav = user_inputs
        _, tsynth = _synths(str(tmp_path), flax_params, midi, short_wav)
        (path,) = tsynth.inference(n_iter=2)
        assert os.path.dirname(path).endswith("audio_output_1")
        y, sr = audio_io.read_wav(path, sr=None)
        _, _, _, t_total = tsynth._chunk_midi(midi, overlap=True)
        assert sr == 44100 and len(y) == t_total * 256
        assert np.all(np.isfinite(y)) and np.abs(y).max() > 0

    def test_cli_serves_a_reference_tar(self, tmp_path, flax_params, user_inputs, monkeypatch):
        """``-exp-name`` resolves checkpoint-{best_epoch}.tar through
        hyperparams.json, forces the MBR compat mode, and writes output-1.wav."""
        midi, _, short_wav = user_inputs
        exp = tmp_path / "experiments" / "ref"
        exp.mkdir(parents=True)
        save_reference_checkpoint(str(exp / "checkpoint-2.tar"), flax_params, epoch=2)
        (exp / "hyperparams.json").write_text(json.dumps({"best_epoch": 2}))
        monkeypatch.chdir(tmp_path)
        cli.main(["-exp-name", "ref", "-midi-source", midi, "-audio-source", short_wav,
                  "--width-mult", str(1 / 16), "--n-iter", "1", "--device", "cpu"])
        y, _ = audio_io.read_wav(str(exp / "audio_output_1" / "output-1.wav"), sr=None)
        assert np.all(np.isfinite(y)) and len(y) > 44100

    def test_degenerate_inputs_fail_with_clear_errors(self, tmp_path, flax_params, user_inputs):
        midi, wav, _ = user_inputs
        empty = str(tmp_path / "empty.mid")
        jmidi_writer.save(empty, [])
        tiny = str(tmp_path / "tiny.wav")
        audio_io.write_wav(tiny, np.zeros(512, np.float32))
        _, synth = _synths(str(tmp_path), flax_params, empty, wav)
        with pytest.raises(ValueError, match="no notes"):
            synth.synthesize_waveform(n_iter=1)
        _, synth = _synths(str(tmp_path), flax_params, midi, tiny)
        with pytest.raises(ValueError, match="shorter than one FFT window"):
            synth.synthesize_waveform(n_iter=1)


class TestDeviceContract:
    """Entry points default to the card and raise without one; the CPU runs
    only when asked for."""

    def _no_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works here")

    def test_synthesizer_default_device_raises(self, tmp_path, flax_params):
        self._no_card()
        state = from_jax_params(flax_params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AudioSynthesizer(str(tmp_path), "m.mid", "a.wav",
                             model_cfg=ModelConfig(**TINY_KW), params=state)
        synth = AudioSynthesizer(str(tmp_path), "m.mid", "a.wav",
                                 model_cfg=ModelConfig(**TINY_KW), params=state, device="cpu")
        assert next(synth.model.parameters()).device.type == "cpu"

    def test_griffinlim_default_device_raises(self):
        self._no_card()
        mag = np.ones((1025, 30), np.float32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgl.griffinlim(mag, n_iter=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgl.griffinlim_from_log_power(mag, n_iter=1)
        assert tgl.griffinlim(mag, n_iter=1, device="cpu").shape == (256 * 29,)

    def test_cli_default_device_raises(self, tmp_path, monkeypatch):
        self._no_card()
        monkeypatch.chdir(tmp_path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-exp-name", "x", "-midi-source", "m.mid", "-audio-source", "a.wav"])

    def test_log_power_stft_stays_on_the_caller_device(self):
        y = torch.zeros(4096)
        assert tstft.log_power_stft(y).device.type == "cpu"
