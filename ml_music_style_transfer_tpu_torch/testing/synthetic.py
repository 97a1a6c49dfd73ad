"""Synthetic MIDI and audio for the daemon's warm-up, demos and tests.

The port's own copy of ``random_song`` and ``render_notes`` from the JAX
package's ``testing/synthetic.py``: a random diatonic piano part, and its
additive-synthesis rendering with a style-specific timbre. Writing a whole
synthetic dataset directory (``make_dataset_dir``) comes with the data path.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..midi.parser import Note

# harmonic amplitude profile + amplitude decay rate per style
STYLE_TIMBRES = {
    "cuba": ((1.0, 0.06, 0.55, 0.05, 0.35, 0.04, 0.22), 2.0),
    "aliciakeys": ((1.0, 0.2, 0.06), 1.2),
    "gentleman": ((1.0, 0.3, 0.1), 0.8),
    "harpsichord": ((1.0, 0.8, 0.6, 0.5, 0.4, 0.3), 4.0),
    "upright": ((1.0, 0.7, 0.45, 0.3, 0.15), 1.6),
}

# Distinct non-envelope timbre features per style. The round-3 5-style TPU
# gate exposed that the original five profiles were all monotonic harmonic
# rolloffs: aliciakeys/cuba/upright targets sat within the trained model's
# error floor of EACH OTHER (inter-target L1 ~ own-prediction L1), so the
# gate measured the fixtures' separability, not the model's discrimination.
# Real instruments differ along more dimensions than rolloff; these add one
# qualitatively different cue each: cuba an odd-harmonic comb (hollow,
# clav-like — encoded in its profile above), aliciakeys an EP-style 5 Hz
# amplitude tremolo, upright piano-string inharmonicity (partial k at
# f0*k*sqrt(1 + B*k^2), audibly stretched octaves).
STYLE_FEATURES = {
    "aliciakeys": {"tremolo": (5.0, 0.6),    # (rate Hz, depth)
                   "bell": (3.58, 0.5)},     # Rhodes-tine partial (ratio, amp)
    "upright": {"stretch": 5e-3,             # inharmonicity coefficient B
                "detune": 6e-3},             # honky-tonk unison detune (beats)
}


def random_song(
    rng: np.random.Generator, duration: float = 20.0, notes_per_sec: float = 3.0
) -> list[Note]:
    """A random plausible piano part: diatonic pitches, varied durations."""
    scale = np.array([0, 2, 4, 5, 7, 9, 11])
    n_notes = max(4, int(duration * notes_per_sec))
    notes = []
    t = 0.0
    for _ in range(n_notes):
        pitch = int(48 + 12 * rng.integers(0, 3) + rng.choice(scale))
        dur = float(rng.uniform(0.15, 0.8))
        vel = int(rng.integers(50, 120))
        notes.append(Note(pitch, vel, round(t, 4), round(min(t + dur, duration), 4)))
        t += float(rng.uniform(0.1, 0.5))
        if t >= duration - 0.2:
            break
    return notes


def render_notes(
    notes: Sequence[Note], style: str, sr: int = 44100,
    duration: float | None = None, normalize: str = "peak",
) -> np.ndarray:
    """Additive-synthesis rendering of notes with a style-specific timbre.

    ``normalize``: "peak" (default; 0.5 peak, the round-1/2 behavior) or
    "rms" — equal loudness (RMS 0.05) across styles, so style-discrimination
    gates face the same bar in both directions instead of the louder style
    discriminating first (round-2 verdict #5: the peak-normalized styles'
    RMS differ ~3x because decay rates differ).
    """
    harmonics, decay = STYLE_TIMBRES[style]
    features = STYLE_FEATURES.get(style, {})
    stretch = features.get("stretch", 0.0)
    tremolo = features.get("tremolo")
    bell = features.get("bell")
    detune = features.get("detune", 0.0)
    if duration is None:
        duration = max((n.end for n in notes), default=1.0) + 0.5
    n_samples = int(duration * sr)
    y = np.zeros(n_samples, dtype=np.float64)
    for note in notes:
        f0 = 440.0 * 2.0 ** ((note.pitch - 69) / 12.0)
        s = int(note.start * sr)
        e = min(int(note.end * sr), n_samples)
        if e <= s:
            continue
        t = np.arange(e - s) / sr
        env = (note.velocity / 127.0) * np.exp(-decay * t)
        env[: min(64, len(env))] *= np.linspace(0, 1, min(64, len(env)))  # declick
        if tremolo is not None:
            rate, depth = tremolo
            env = env * (1.0 - depth * (0.5 - 0.5 * np.cos(2 * np.pi * rate * t)))
        seg = np.zeros(e - s)
        for k, amp in enumerate(harmonics, start=1):
            fk = f0 * k * np.sqrt(1.0 + stretch * k * k)
            if fk < sr / 2:
                if detune:
                    # two detuned unison strings -> f0*k*2*detune Hz beating
                    seg += 0.5 * amp * (
                        np.sin(2 * np.pi * fk * (1 + detune) * t)
                        + np.sin(2 * np.pi * fk * (1 - detune) * t))
                else:
                    seg += amp * np.sin(2 * np.pi * fk * t)
        if bell is not None and f0 * bell[0] < sr / 2:
            seg += bell[1] * np.sin(2 * np.pi * f0 * bell[0] * t)
        y[s:e] += env * seg
    if normalize == "peak":
        peak = np.max(np.abs(y))
        if peak > 0:
            y = 0.5 * y / peak
    elif normalize == "rms":
        rms = float(np.sqrt(np.mean(y * y)))
        if rms > 0:
            y = y * (0.05 / rms)
        peak = np.max(np.abs(y))
        if peak > 0.99:  # guard the 16-bit writer's clip; rare at RMS 0.05
            y = y * (0.99 / peak)
    else:
        raise ValueError(f"unknown normalize {normalize!r}")
    return y.astype(np.float32)
