"""Visual spectrogram diagnostic: the port's counterpart of the JAX
package's ``testing/plot_spec.py`` (reference tests/plot_spec.py).

The log-power, raw-magnitude and 128-band mel spectrograms of one audio
chunk side by side, for an eyeball comparison of the representations.
``spec_panels`` computes the three panels with NumPy alone;
``plot_spec`` draws them and needs matplotlib, which not every machine
has (the card's does not): there it raises ``ImportError`` saying so.

    python -m ml_music_style_transfer_tpu_torch.testing.plot_spec AUDIO.wav [OUT.png]
"""
from __future__ import annotations

import sys

import numpy as np

from ..config import DEFAULT_DSP, DSPConfig
from ..data import audio_io
from ..ops import reference as npref

TITLES = ("log-power log1p(|S|^2) (training representation)", "raw magnitude |S|",
          "mel (128 bands, log1p)")


def spec_panels(y: np.ndarray, hp: DSPConfig = DEFAULT_DSP) -> list[np.ndarray]:
    """The first chunk of ``y`` as (log-power, magnitude, log1p mel), each
    (bins or bands, frames), float64."""
    mag = np.abs(npref.stft(y[: hp.samples_per_chunk], hp.n_fft, hp.ws))
    mel = npref.mel_filterbank(hp.sr, hp.n_fft, 128) @ (mag**2)
    return [np.log1p(mag**2), mag, np.log1p(mel)]


def plot_spec(audio_path: str, out_path: str = "plot_spec.png") -> str:
    """Draw ``spec_panels`` of the WAV at ``audio_path`` into ``out_path``."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_spec draws with matplotlib, which is not installed here; "
                          "spec_panels computes the panels without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y, _ = audio_io.read_wav(audio_path, sr=DEFAULT_DSP.sr)
    fig, axes = plt.subplots(3, 1, figsize=(10, 9), sharex=True)
    for ax, data, title in zip(axes, spec_panels(y), TITLES):
        ax.imshow(data, origin="lower", aspect="auto", cmap="magma")
        ax.set_title(title)
        ax.set_ylabel("bin")
    axes[-1].set_xlabel("frame")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    print(plot_spec(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "plot_spec.png"))
