"""The one generator of serving traffic: MIDI scores, timbre recordings and
the order and arrival times of requests, all from the run's seed and the
parameters of a traffic file.

Every seed gets the same multiset of sizes and gaps in another order, so
that the seed changes which score meets which timbre and when, never how
much work a window holds:
  - score lengths are the lognormal's quantiles at (i + 0.5) / n, clipped;
  - timbre lengths are spread evenly over their range, their sample rates
    taken in turn;
  - requests come in blocks that use every score once and every timbre
    equally often;
  - an open loop's gaps are the exponential's quantiles for the arrivals
    its window holds, shuffled.
"""
from __future__ import annotations

import hashlib
import math
import os
import statistics
import wave

import numpy as np

TPQ, TEMPO = 480, 500_000  # ticks per quarter, microseconds per quarter (120 bpm)
TICKS_PER_S = 1e6 * TPQ / TEMPO  # 960
MIN_GAP_FRAMES = 2  # frames between two notes of one pitch, so no two overlap


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def tick_seconds(tick: int) -> float:
    """Seconds of a tick at the fixed tempo, as a MIDI reader computes them."""
    return tick * TEMPO / (1e6 * TPQ)


def lognormal_quantiles(n: int, median: float, sigma: float, lo: float, hi: float) -> list[float]:
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return [min(hi, max(lo, median * math.exp(sigma * v))) for v in z]


def song(rng: np.random.Generator, seconds: float, fps: int) -> list[tuple[int, int, int]]:
    """A random diatonic part as (pitch, start tick, end tick) notes that
    ends at ``seconds``. Every start and end lies mid-frame at ``fps`` frames
    a second, so the frame a reader puts it in does not hang on rounding,
    and notes of one pitch never overlap."""
    scale = np.array([0, 2, 4, 5, 7, 9, 11])

    def tick(frame: float) -> int:
        return int(round((frame + 0.5) / fps * TICKS_PER_S))

    n_frames = int(seconds * fps)
    notes, free_at = [], {}
    f = 0
    while True:
        pitch = int(48 + 12 * rng.integers(0, 3) + rng.choice(scale))
        dur = int(rng.integers(int(0.15 * fps), int(0.8 * fps)))
        end = min(f + dur, n_frames - 1)
        if end > f and free_at.get(pitch, 0) <= f:
            notes.append((pitch, tick(f), tick(end)))
            free_at[pitch] = end + MIN_GAP_FRAMES
        f += int(rng.integers(int(0.1 * fps), int(0.5 * fps)))
        if f >= n_frames - int(0.2 * fps):
            break
    # the last note ends where the score does: its roll has n_frames frames
    start = max(free_at.get(60, 0), n_frames - int(0.3 * fps))
    notes.append((60, tick(min(start, n_frames - 2)), tick(n_frames - 1)))
    return notes


def notes_seconds(notes) -> list[tuple[int, float, float]]:
    return [(p, tick_seconds(s), tick_seconds(e)) for p, s, e in notes]


def _varlen(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def write_midi(path: str, notes) -> None:
    """A format-0 Standard MIDI File of (pitch, start tick, end tick) notes."""
    events = []
    for pitch, s, e in notes:
        events.append((s, 1, 0x90, pitch, 80))
        events.append((e, 0, 0x80, pitch, 0))
    events.sort(key=lambda ev: (ev[0], ev[1]))
    body = bytearray(_varlen(0) + bytes([0xFF, 0x51, 0x03]) + TEMPO.to_bytes(3, "big"))
    last = 0
    for t, _, status, pitch, vel in events:
        body += _varlen(t - last) + bytes([status, pitch, vel])
        last = t
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])
    head = b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big") + (1).to_bytes(2, "big")
    head += TPQ.to_bytes(2, "big")
    with open(path, "wb") as f:
        f.write(head + b"MTrk" + len(body).to_bytes(4, "big") + bytes(body))


def timbre(rng: np.random.Generator, seconds: float, sr: int) -> np.ndarray:
    """A stereo int16 recording of random notes: a few decaying harmonics
    each, a timbre of their own per file (harmonic weights, decay)."""
    n = int(seconds * sr)
    y = np.zeros((n, 2), np.float64)
    harmonics = rng.uniform(0.05, 1.0, 6) / np.arange(1, 7)
    decay = rng.uniform(1.0, 6.0)
    t = 0.0
    while t < seconds - 0.1:
        f0 = 440.0 * 2.0 ** ((int(rng.integers(40, 80)) - 69) / 12.0)
        s, length = int(t * sr), int(rng.uniform(0.2, 1.0) * sr)
        e = min(s + length, n)
        tt = np.arange(e - s) / sr
        seg = sum(a * np.sin(2 * np.pi * f0 * k * tt) for k, a in enumerate(harmonics, 1)
                  if f0 * k < sr / 2)
        seg = seg * np.exp(-decay * tt) * rng.uniform(0.3, 1.0)
        pan = rng.uniform(0.2, 0.8)
        y[s:e, 0] += pan * seg
        y[s:e, 1] += (1 - pan) * seg
        t += rng.uniform(0.1, 0.4)
    y *= 0.5 / max(1e-9, np.abs(y).max())
    return (y * 32767.0).astype("<i2")


def write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    with wave.open(path, "wb") as f:
        f.setnchannels(samples.shape[1] if samples.ndim == 2 else 1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.ascontiguousarray(samples).tobytes())


class ServingTraffic:
    """The scores, timbres and request stream of one serving run.

    ``mix``: the traffic file's parameters; ``fps`` the piano roll's frames
    per second. Files go to ``root``."""

    def __init__(self, mix: dict, seed: int, root: str, fps: int):
        self.mix, self.root, self.fps = mix, root, fps
        rng = np.random.default_rng(sub_seed(seed, "traffic"))
        m, t = mix["midi"], mix["timbre"]
        lengths = lognormal_quantiles(m["pool"], m["median_s"], m["sigma"], m["min_s"], m["max_s"])
        self.midis = []
        for i, sec in enumerate(lengths):
            notes = song(rng, sec, fps)
            path = os.path.join(root, f"score{i}.mid")
            write_midi(path, notes)
            self.midis.append({"path": path, "notes": notes, "seconds": sec})
        rates = t["rates"]
        self.timbres = []
        for i in range(t["pool"]):
            sec = t["min_s"] + (t["max_s"] - t["min_s"]) * (i + 0.5) / t["pool"]
            sr = rates[i % len(rates)]
            path = os.path.join(root, f"timbre{i}.wav")
            write_wav(path, timbre(rng, sec, sr), sr)
            self.timbres.append({"path": path, "seconds": sec, "rate": sr})
        self.rng = rng
        self.out_dir = os.path.join(root, "answers")
        os.makedirs(self.out_dir, exist_ok=True)

    def block(self) -> list[tuple[int, int]]:
        """One block of (score, timbre) pairs: every score once, the timbres
        equally often, both orders from the seed."""
        n_m, n_t = len(self.midis), len(self.timbres)
        order = self.rng.permutation(n_m)
        timbres = self.rng.permutation(np.resize(np.arange(n_t), n_m))
        return [(int(a), int(b)) for a, b in zip(order, timbres)]

    def warmup_pairs(self) -> list[tuple[int, int]]:
        """Every score once, the timbres in turn: every shape the window
        meets (tile counts, Griffin-Lim frames, conditioning buckets)."""
        return [(i, i % len(self.timbres)) for i in range(len(self.midis))]

    def gaps(self, rate: float, seconds: float) -> list[float]:
        """The gaps of a Poisson stream at ``rate`` per second over a window
        of ``seconds``: the exponential's quantiles at (i + 0.5) / n for the
        n = rate x seconds arrivals the window holds, shuffled, so every
        seed brings the same arrivals in another order."""
        n = max(1, round(rate * seconds))
        base = np.array([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)])
        return self.rng.permutation(base).tolist()

    def request(self, k: int, pair: tuple[int, int]) -> dict:
        m = self.mix
        return {"midi": self.midis[pair[0]]["path"], "audio": self.timbres[pair[1]]["path"],
                "out": os.path.join(self.out_dir, f"a{k}.wav"), "n_iter": m["n_iter"],
                "cond_mode": m["cond_mode"], "overlap": m["overlap"]}
