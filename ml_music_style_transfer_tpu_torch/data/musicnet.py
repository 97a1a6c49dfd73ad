"""MusicNet curation: the solo-piano piece IDs from its label CSVs.

The port's own copy of the JAX package's ``data/musicnet.py`` (reference
preprocessing/extract_piano_pieces_from_musicnet_dataset.py): scan
``{data_type}_labels/*.csv``, keep the songs whose only instrument label is
piano (1), and write the ID list to ``{basename}_{data_type}.txt``.

    python -m ml_music_style_transfer_tpu_torch.data.musicnet PATH \
        [--data-type train|test] [--output-file-basename piano_pieces]
"""
from __future__ import annotations

import argparse
import csv
import glob
import os

PIANO_INSTRUMENT_LABEL = 1  # reference extract_...py:8


def extract_piano_pieces(
    path_to_musicnet: str, data_type: str = "train", output_file_basename: str = "piano_pieces"
) -> list[str]:
    """Return (and write) the solo-piano song IDs (reference main(), :10-24)."""
    piano_ids: list[str] = []
    pattern = os.path.join(path_to_musicnet, f"{data_type}_labels", "*.csv")
    for csv_path in sorted(glob.glob(pattern)):
        instruments = set()
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                instruments.add(int(row["instrument"]))
        if instruments == {PIANO_INSTRUMENT_LABEL}:
            piano_ids.append(os.path.splitext(os.path.basename(csv_path))[0])
    with open(f"{output_file_basename}_{data_type}.txt", "w") as f:
        f.writelines(f"{song_id}\n" for song_id in piano_ids)
    return piano_ids


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path_to_musicnet")
    ap.add_argument("--data-type", default="train", choices=["train", "test"])
    ap.add_argument("--output-file-basename", default="piano_pieces")
    args = ap.parse_args(argv)
    ids = extract_piano_pieces(args.path_to_musicnet, args.data_type, args.output_file_basename)
    print(f"{len(ids)} solo piano pieces")
    return ids


if __name__ == "__main__":
    main()
