"""Inference CLI — the reference's inference.py entry point, same flags,
plus ``--device`` (default ``cuda``; with no card it fails).

    python -m ml_music_style_transfer_tpu_torch.infer.cli \
        -exp-name NAME -midi-source PATH -audio-source PATH [--width-mult F]

The experiment dir is ./experiments/{exp_name}; without ``--checkpoint`` the
checkpoint of the best_epoch named by its hyperparams.json is loaded: the
port's ``checkpoint-{best_epoch}.pt`` or ``.dcp`` (of which only the served
tree is read), the JAX package's ``.msgpack`` or ``.orbax`` or the
reference's ``.tar``
(reference model/inference.py:112-124). On the card
every CUDA kernel is built first (``utils/profiling
.enable_persistent_compile_cache``; ``MMST_COMPILE_CACHE=0`` skips it).
"""
from __future__ import annotations

import argparse
import os

from ..config import ModelConfig
from ..utils.profiling import enable_persistent_compile_cache
from .synthesize import AudioSynthesizer


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-exp-name", dest="exp_name", type=str, required=True)
    p.add_argument("-midi-source", dest="midi_source", type=str, required=True)
    p.add_argument("-audio-source", dest="audio_source", type=str, required=True)
    p.add_argument("--width-mult", type=float, default=1.0,
                   help="must match the trained model's width")
    p.add_argument("--n-iter", type=int, default=300, help="Griffin-Lim iterations")
    p.add_argument("--compat-mbr-noop", action="store_true",
                   help="reproduce the reference MBRBlock's literal 2*x "
                        "behavior (forced automatically for .tar checkpoints)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="explicit checkpoint path (.pt, .dcp, JAX .msgpack or .orbax, or "
                        "reference .tar); default resolves via hyperparams.json best_epoch")
    p.add_argument("--use-ema", action="store_true",
                   help="serve the EMA weights a run with --ema-decay checkpointed")
    p.add_argument("--cond-mode", choices=("aligned", "center"), default="aligned",
                   help="'aligned': each MIDI tile conditions on the audio at "
                        "its own time position; 'center': one center 5s crop "
                        "broadcast to all tiles")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)
    enable_persistent_compile_cache(args.device)  # every kernel built before the request

    exp_dir = os.path.join(os.path.abspath("./experiments"), args.exp_name)
    synth = AudioSynthesizer(
        exp_dir, args.midi_source, args.audio_source,
        model_cfg=ModelConfig(width_mult=args.width_mult,
                              compat_mbr_noop=args.compat_mbr_noop),
        checkpoint_path=args.checkpoint,
        use_ema=args.use_ema,
        device=args.device,
    )
    outs = synth.inference(n_iter=args.n_iter, cond_mode=args.cond_mode)
    for o in outs:
        print(f"wrote {o}")


if __name__ == "__main__":
    main()
