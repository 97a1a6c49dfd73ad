"""Preprocessing: (MIDI, multi-style WAV) -> aligned chunks in an HDF5 file.

The port of the JAX package's ``data/preprocess.py`` (reference
preprocessing/preprocess.py:163-232), with the same entry points, flags
and file schema, plus ``--device``. Per song the MIDI becomes a binarized
piano roll and its onset/offset matrix, cut into 860-frame chunks; per
(song, style) the WAV is cut into the matching 219,904-sample chunks, and
their log-power spectrograms are computed in batches of 32 chunks:

  - ``stft_backend="device"``: the port's ``ops/stft.log_power_stft`` on
    ``device`` (the card unless the caller asks for the CPU);
  - ``"host"``: the NumPy reference (``ops/reference.py``), float64;
  - ``"auto"``: measure once which is faster on this host and link
    (``resolve_stft_backend``); on the CPU it is ``"device"``, no probe.

A style whose audio is missing for a song is skipped with a notice
(preprocess.py:185-190); ``--debug`` writes wav + mid per chunk for
listening back (io_manager.py:22-36). A producer thread decodes the next
WAV while this one computes and writes the current one.

``get_data`` writes ``{dataset_outpath}_{data_type}.hdf5`` (needs h5py);
``get_arrays`` runs the same pipeline into host memory and returns the
arrays that ``load_dataset`` would read from that file.

CLI:
    python -m ml_music_style_transfer_tpu_torch.data.preprocess \\
        -data-dir DIR -dataset-outpath OUT [-data-type train|test] \\
        [-max-chunks-per-song N] [--song-ids ID ...] [--store-audio true] \\
        [--stft-backend auto|device|host] [--skip-spectrum true] [--debug true] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import os
import queue
import threading
import time
import zipfile

import numpy as np
import torch

from ..config import DEFAULT_DSP, PIANO_SCORES, STYLES, DSPConfig
from ..device import resolve_device
from ..midi import parser as midi_parser
from ..midi import pianoroll as pr
from ..midi import writer as midi_writer
from ..ops import reference as npref
from ..ops import stft as tstft
from . import audio_io, chunking
from .hdf5_store import ArrayStore, H5Store

DEBUG_DIR = "debugdir"
_STFT_BATCH = 32  # chunks per device batch (bounds device memory and host staging)

# the 'auto' backend decision, measured once per device and process
_AUTO_BACKEND_CACHE: dict[str, str] = {}


def probe_link_bandwidth(device: torch.device, nbytes: int = 4 << 20) -> float:
    """Host <-> device round-trip bandwidth in GB/s (bytes moved both ways
    over the wall time), from pinned memory, after a small warm-up copy."""
    src = torch.zeros(nbytes // 4, dtype=torch.float32).pin_memory()
    back = torch.empty_like(src).pin_memory()
    src[:256].to(device).cpu()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    back.copy_(src.to(device, non_blocking=True), non_blocking=True)
    torch.cuda.synchronize(device)
    dt = max(time.perf_counter() - t0, 1e-9)
    return 2 * nbytes / dt / 1e9


def _host_stft_seconds(hp: DSPConfig = DEFAULT_DSP) -> float:
    """Wall seconds for ONE chunk's log-power STFT on the host (the NumPy
    reference), best of two."""
    chunk = np.random.default_rng(0).standard_normal(hp.samples_per_chunk).astype(np.float32)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        npref.log_power(npref.stft(chunk, hp.n_fft, hp.ws))
        best = min(best, time.perf_counter() - t0)
    return best


def _auto_choice(link_gbps: float, host_stft_s: float, hp: DSPConfig = DEFAULT_DSP) -> str:
    """The decision rule: on a slow link the device path's cost per chunk
    is its transfer (samples up, the (bins x frames) float32 spectrogram
    down), against the host's STFT of one chunk. Breakeven is ~0.09 GB/s
    for the reference chunk geometry."""
    chunk_bytes = (hp.samples_per_chunk + hp.n_freq_bins * hp.windows_per_chunk) * 4
    device_s = chunk_bytes / (link_gbps * 1e9)
    return "device" if device_s < host_stft_s else "host"


def resolve_stft_backend(backend: str, hp: DSPConfig = DEFAULT_DSP, device="cuda") -> str:
    """'device' and 'host' pass through; 'auto' measures this host and link
    once per device and process. On the CPU 'auto' is 'device' with no
    probe: the device is this host, and the batched torch STFT beats the
    per-chunk NumPy loop."""
    if backend != "auto":
        if backend not in ("device", "host"):
            raise ValueError(
                f"stft backend must be 'auto', 'device' or 'host', got {backend!r}")
        return backend
    dev = resolve_device(device)
    if str(dev) in _AUTO_BACKEND_CACHE:
        return _AUTO_BACKEND_CACHE[str(dev)]
    if dev.type == "cpu":
        choice = "device"
    else:
        bw = probe_link_bandwidth(dev)
        host_s = _host_stft_seconds(hp)
        choice = _auto_choice(bw, host_s, hp)
        chunk_bytes = (hp.samples_per_chunk + hp.n_freq_bins * hp.windows_per_chunk) * 4
        print(f"stft backend auto: link {bw:.3f} GB/s -> "
              f"{chunk_bytes / (bw * 1e9) * 1e3:.1f} ms/chunk transfer vs "
              f"host STFT {host_s * 1e3:.1f} ms/chunk -> '{choice}'")
    _AUTO_BACKEND_CACHE[str(dev)] = choice
    return choice


def str2bool(v) -> bool:
    """CLI boolean (reference io_manager.py:10-19)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _one_match(pattern: str, what: str) -> str:
    matches = glob.glob(pattern)
    if len(matches) == 0:
        raise ValueError(f"couldnt find {what}!")
    if len(matches) > 1:
        raise ValueError(f"multiple files picked up: {matches}")
    return matches[0]


def load_audio(data_dir: str, song_id, style: str, hp: DSPConfig = DEFAULT_DSP) -> np.ndarray:
    """Glob {song_id}*{style}.wav and load it at hp.sr (preprocess.py:99-115)."""
    y, _ = audio_io.read_wav(_one_match(f"{data_dir}/{song_id}*{style}.wav", "audio track"),
                             sr=hp.sr)
    return y


def load_midi(data_dir: str, song_id, ext: str = "mixcraft", hp: DSPConfig = DEFAULT_DSP):
    """Glob {song_id}*{ext}.mid -> (binarized roll, onoff) at wps Hz
    (preprocess.py:139-160, the onoff loop vectorized)."""
    mf = midi_parser.load(_one_match(f"{data_dir}/{song_id}*{ext}.mid", "midi track"))
    return pr.vectorize_notes(mf.notes, hp.wps)


def spectrograms_from_chunks(audio_chunks: np.ndarray, hp: DSPConfig = DEFAULT_DSP,
                             backend: str = "device", device="cuda") -> np.ndarray:
    """(N, samples) -> (N, 1025, 860) float32 log-power spectrograms.

    ``backend="device"``: ``log_power_stft`` on ``device`` in batches of
    ``_STFT_BATCH`` chunks, each uploaded through pinned memory.
    ``backend="host"``: the NumPy reference in float64, chunk by chunk.
    The two agree within 5e-4 in log space (float32 FFT against float64).
    """
    empty = np.zeros((0, hp.n_freq_bins, hp.windows_per_chunk), np.float32)
    if backend == "host":
        if not len(audio_chunks):
            return empty
        return np.stack([npref.log_power(npref.stft(c, hp.n_fft, hp.ws))
                         for c in audio_chunks]).astype(np.float32)
    if backend != "device":
        raise ValueError(f"stft backend must be 'device' or 'host', got {backend!r}")
    dev = resolve_device(device)
    outs = []
    with torch.inference_mode():
        for i in range(0, len(audio_chunks), _STFT_BATCH):
            batch = tstft.to_device(torch.from_numpy(
                np.ascontiguousarray(audio_chunks[i:i + _STFT_BATCH], dtype=np.float32)), dev)
            outs.append(tstft.log_power_stft(batch, hp.n_fft, hp.ws).cpu().numpy())
    return np.concatenate(outs, axis=0) if outs else empty


def _write_debug_samples(debug_dir, song_id, step, hp, style=None, audio_chunk=None,
                         roll_chunk=None):
    """Listen-back alignment dumps (reference io_manager.py:22-36)."""
    os.makedirs(debug_dir, exist_ok=True)
    if audio_chunk is not None:
        audio_io.write_wav(os.path.join(debug_dir, f"{song_id}_{style}_c{step}.wav"),
                           audio_chunk, hp.sr)
    if roll_chunk is not None:
        notes = pr.pianoroll_to_notes(roll_chunk, hp.wps)
        midi_writer.save(os.path.join(debug_dir, f"{song_id}_c{step}.mid"), notes)


def discover_song_ids(data_dir: str, ext: str = "mixcraft") -> list[int]:
    """Song ids present in a dataset dir, from the ``{id}*{ext}.mid``
    naming contract (preprocess.py:140 glob); the reference hard-codes its
    MusicNet list (preprocess.py:28-34)."""
    ids = set()
    for p in glob.glob(os.path.join(data_dir, f"*{ext}.mid")):
        head = os.path.basename(p).split("_")[0]
        if head.isdigit():
            ids.add(int(head))
    return sorted(ids)


def discover_styles(data_dir: str) -> list[str]:
    """Timbre styles present in a dataset dir: the final underscore token of
    each ``{id}_..._{style}.wav`` (reference naming, preprocess.py:100)."""
    styles = set()
    for p in glob.glob(os.path.join(data_dir, "*.wav")):
        stem = os.path.basename(p)[: -len(".wav")]
        if "_" in stem:
            styles.add(stem.rsplit("_", 1)[1])
    return sorted(styles)


def _decode_ahead(data_dir, song_ids, styles, hp, depth: int = 2):
    """Yield (song_id, style, audio | None) in order while a producer thread
    decodes the next files (WAV read + resample is the host's larger cost).
    None means the style's file is missing or unreadable (the reference's
    graceful skip, preprocess.py:185-190); any other error in the producer
    is raised here."""
    jobs = [(sid, st) for sid in song_ids for st in styles]
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))

    def producer():
        for sid, st in jobs:
            try:
                audio = load_audio(data_dir, sid, st, hp)
            except (ValueError, OSError):
                audio = None
            except BaseException as e:  # re-raised by the consumer below
                q.put(e)
                return
            q.put((sid, st, audio))

    t = threading.Thread(target=producer, name="decode-ahead", daemon=True)
    t.start()
    for _ in jobs:
        item = q.get()
        if isinstance(item, BaseException):
            t.join()
            raise item
        yield item
    t.join()


def _preprocess_into(store, data_dir, data_type, debug, hp, song_ids, styles, max_chunks,
                     store_audio, prefetch, stft_backend, write_spectrum, device) -> None:
    """The pipeline of ``get_data`` and ``get_arrays``, writing to ``store``."""
    if not write_spectrum and not store_audio:
        raise ValueError("write_spectrum=False requires store_audio=True "
                         "(the file would contain no conditioning source)")
    if write_spectrum:
        stft_backend = resolve_stft_backend(stft_backend, hp, device)
    song_ids = PIANO_SCORES[data_type] if song_ids is None else song_ids
    styles = STYLES if styles is None else styles
    chunks_by_song = {}
    for song_id in song_ids:
        roll, onoff = load_midi(data_dir, song_id, hp=hp)
        num_chunks = chunking.num_song_chunks(roll.shape[0], hp, max_chunks=max_chunks)
        print(f"song {song_id}: {num_chunks} chunks")
        roll_chunks = chunking.chunk_pianoroll(roll, num_chunks, hp)
        onoff_chunks = chunking.chunk_pianoroll(onoff, num_chunks, hp)
        if debug:
            for step in range(num_chunks):
                _write_debug_samples(DEBUG_DIR, song_id, step, hp, roll_chunk=roll_chunks[step])
        store.write_pianoroll(roll_chunks, onoff_chunks)
        # only the counts and shapes are needed below (debug alignment checks)
        chunks_by_song[song_id] = (num_chunks, roll_chunks.shape, onoff_chunks.shape)
        if prefetch:
            continue  # the audio goes through the decode-ahead pass below
        for style in styles:
            try:
                audio = load_audio(data_dir, song_id, style, hp)
            except (ValueError, OSError):
                # not all styles exist for all midi (preprocess.py:185-190)
                print(f"Couldnt load audio for song={song_id}, style={style}, skipping...")
                continue
            _ingest_style_audio(store, audio, song_id, style, chunks_by_song[song_id], hp,
                                debug, store_audio, stft_backend, write_spectrum, device)
    if prefetch:
        for song_id, style, audio in _decode_ahead(data_dir, song_ids, styles, hp):
            if audio is None:
                print(f"Couldnt load audio for song={song_id}, style={style}, skipping...")
                continue
            _ingest_style_audio(store, audio, song_id, style, chunks_by_song[song_id], hp,
                                debug, store_audio, stft_backend, write_spectrum, device)


def get_data(
    data_dir: str,
    dataset_outpath: str,
    data_type: str,
    debug: bool = False,
    hp: DSPConfig = DEFAULT_DSP,
    song_ids=None,
    styles=None,
    max_chunks: int = 100,
    dtype: str = "float32",
    store_audio: bool = False,
    prefetch: bool = True,
    stft_backend: str = "auto",
    write_spectrum: bool = True,
    device="cuda",
) -> str:
    """Build ``{dataset_outpath}_{data_type}.hdf5`` (reference
    preprocess.py:163-200) and return its path.

    ``song_ids``/``styles`` default to the MusicNet split and the five
    reference styles (``config.PIANO_SCORES``, ``config.STYLES``).
    ``store_audio`` also writes the raw audio chunks (``audio_{style}``)
    for device-resident training; ``write_spectrum=False`` (needs
    ``store_audio``) writes no ``spec_{style}`` at all, since the resident
    path recomputes them on the device. ``prefetch=False`` decodes the WAVs
    serially. ``device`` runs the 'device' STFT backend (and 'auto''s
    probe).
    """
    import h5py

    h5pyname = f"{dataset_outpath}_{data_type}.hdf5"
    with h5py.File(h5pyname, "w") as h5f:
        _preprocess_into(H5Store(h5f, dtype=dtype), data_dir, data_type, debug, hp, song_ids,
                         styles, max_chunks, store_audio, prefetch, stft_backend,
                         write_spectrum, device)
    return h5pyname


def get_arrays(
    data_dir: str,
    data_type: str = "train",
    debug: bool = False,
    hp: DSPConfig = DEFAULT_DSP,
    song_ids=None,
    styles=None,
    max_chunks: int = 100,
    dtype: str = "float32",
    store_audio: bool = False,
    prefetch: bool = True,
    stft_backend: str = "auto",
    write_spectrum: bool = True,
    device="cuda",
) -> dict[str, np.ndarray]:
    """``get_data``'s pipeline into host memory: returns the arrays that
    ``load_dataset`` reads from the file ``get_data`` writes, with no file
    and no h5py."""
    store = ArrayStore(dtype=dtype)
    _preprocess_into(store, data_dir, data_type, debug, hp, song_ids, styles, max_chunks,
                     store_audio, prefetch, stft_backend, write_spectrum, device)
    return store.arrays()


def _ingest_style_audio(store, audio, song_id, style, song_chunks, hp, debug, store_audio,
                        stft_backend, write_spectrum, device) -> None:
    """Chunk one style's decoded audio, STFT it, write it to the store."""
    num_chunks, roll_shape, onoff_shape = song_chunks
    audio_chunks = chunking.chunk_audio(audio, num_chunks, hp)
    if debug:
        for step in range(num_chunks):
            _write_debug_samples(DEBUG_DIR, song_id, step, hp, style=style,
                                 audio_chunk=audio_chunks[step])
    if write_spectrum:
        spec_chunks = spectrograms_from_chunks(audio_chunks, hp, backend=stft_backend,
                                               device=device)
        store.write_spectrum(spec_chunks, style)
        if debug and roll_shape[0] != spec_chunks.shape[0]:
            raise ValueError(f"song {song_id} style {style}: {spec_chunks.shape[0]} "
                             f"spectrogram chunks for {roll_shape[0]} roll chunks")
    if store_audio:
        store.write_audio(audio_chunks, style)
    if debug and roll_shape != onoff_shape:
        raise ValueError(f"song {song_id}: roll {roll_shape} and onoff {onoff_shape} differ")


def main(args) -> str:
    if zipfile.is_zipfile(args.data_dir):
        print("Extracting zip file to local")
        cwd = os.getcwd()
        with zipfile.ZipFile(args.data_dir, "r") as zf:
            root = os.path.dirname(zf.namelist()[0])
            zf.extractall(cwd)
        args.data_dir = os.path.join(cwd, root)
    return get_data(
        args.data_dir,
        args.dataset_outpath,
        args.data_type,
        debug=args.debug,
        max_chunks=args.max_chunks_per_song,
        song_ids=args.song_ids,
        store_audio=args.store_audio,
        stft_backend=args.stft_backend,
        write_spectrum=not args.skip_spectrum,
        device=args.device,
    )


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-data-dir", dest="data_dir", type=str, required=True,
                        help="dataset directory (or a zipfile to extract)")
    parser.add_argument("-dataset-outpath", dest="dataset_outpath", type=str, required=True,
                        help="output basename; _{data-type}.hdf5 is appended")
    parser.add_argument("-max-chunks-per-song", dest="max_chunks_per_song", type=int,
                        default=100)
    parser.add_argument("-data-type", dest="data_type", type=str, default="train",
                        choices=["train", "test"])
    parser.add_argument("--debug", type=str2bool, default=False,
                        help="write per-chunk wav/mid alignment dumps to debugdir")
    parser.add_argument("--song-ids", dest="song_ids", type=int, nargs="*", default=None,
                        help="override the built-in MusicNet id list")
    parser.add_argument("--store-audio", type=str2bool, default=False,
                        help="also store raw audio chunks (audio_{style} keys) for "
                             "device-resident training")
    parser.add_argument("--stft-backend", choices=("auto", "device", "host"), default="auto",
                        help="where spectrograms are computed: 'auto' (probes the "
                             "host<->device link once and picks the faster side), "
                             "'device' (batched torch STFT on --device) or 'host' (NumPy)")
    parser.add_argument("--skip-spectrum", type=str2bool, default=False,
                        help="write no spec_{style} datasets (needs --store-audio true): "
                             "device-resident training recomputes them on the device")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the 'device' STFT backend; 'cpu' only "
                             "when asked for")
    return parser


def cli(argv=None) -> str:
    return main(build_argparser().parse_args(argv))


if __name__ == "__main__":
    cli()
