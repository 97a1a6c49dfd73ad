"""Export a trained experiment as a reference-format ``.tar`` checkpoint:
the port's counterpart of the JAX package's
``scripts/export_torch_checkpoint.py``.

    python -m ml_music_style_transfer_tpu_torch.scripts.export_torch_checkpoint \\
        -exp-name NAME [--exp-root ./experiments] [--epoch N] [--use-ema] [--out PATH] \\
        [--width-mult 1.0] [--device cuda|cpu]

The epoch is hyperparams.json's ``best_epoch`` (the reference's own
contract, model/inference.py:22-29) unless ``--epoch`` names one. The
checkpoint may be the port's ``checkpoint-{epoch}.pt`` or ``.dcp``, or the
JAX package's ``checkpoint-{epoch}.msgpack`` or ``.orbax`` (written by one
process or by the ranks of a mesh), found in that order; ``--use-ema``
exports its EMA weights. The output, ``{exp_dir}/checkpoint-{epoch}.tar`` by default, is
``{"epoch", "state_dict", "optimizer": None}`` with float32 tensors under
the reference's keys (``compat/weights.save_reference_checkpoint``). Only
full-width (``width_mult=1.0``) weights fit the reference's strict load.
``--width-mult`` is the experiment's width: the weights are taken under the
keys of a ``PerformanceNet`` of that width, as the JAX script's restore
template takes a ``.msgpack`` (flax checks the template's keys, not their
shapes): a key the model has and the checkpoint lacks raises, naming it,
and keys the model lacks are left out. A ``.pt`` or ``.dcp`` is taken the
same way; an ``.orbax`` is exported as it is, as the JAX script restores it
without a template.
A ``.msgpack``'s weights are translated from the JAX layout on
``--device`` (the card by default, as at every entry point of the port;
``--device cpu`` where there is none); the file is written from the CPU.
"""
from __future__ import annotations

import argparse
import os

from ..compat.weights import save_reference_checkpoint
from ..config import ModelConfig
from ..device import resolve_device
from ..infer.synthesize import load_checkpoint_params
from ..models import PerformanceNet
from ..train import checkpoint as ckpt


def fit_template(params: dict, width_mult: float) -> dict:
    """``params`` under the keys of a PerformanceNet of ``width_mult``, in
    its order: a key the model has and ``params`` lacks raises ValueError
    naming the first; keys the model lacks are dropped (flax's restore
    into a template)."""
    template = PerformanceNet(ModelConfig(width_mult=width_mult), device="meta").state_dict()
    missing = [k for k in template if k not in params]
    if missing:
        raise ValueError(f"the checkpoint has no {missing[0]!r}, which a PerformanceNet of "
                         f"width_mult {width_mult:g} has ({len(missing)} such keys)")
    return {k: params[k] for k in template}


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-exp-name", dest="exp_name", required=True)
    ap.add_argument("--exp-root", default="./experiments")
    ap.add_argument("--epoch", type=int, default=None,
                    help="checkpoint epoch (default: hyperparams.json best_epoch)")
    ap.add_argument("--use-ema", action="store_true",
                    help="export the EMA weights (the ema_params tree)")
    ap.add_argument("--out", default=None,
                    help="output path (default: {exp_dir}/checkpoint-{epoch}.tar)")
    ap.add_argument("--width-mult", type=float, default=1.0,
                    help="the experiment's width (the keys a .msgpack, .pt or .dcp must hold)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    exp_dir = os.path.join(os.path.abspath(args.exp_root), args.exp_name)
    if args.epoch is None:
        path, epoch = ckpt.best_checkpoint(exp_dir)
    else:
        epoch = args.epoch
        found = [p for p in (ckpt.checkpoint_path(exp_dir, epoch, fmt)
                             for fmt in ("torch", "msgpack", "dcp", "orbax")) if os.path.exists(p)]
        if not found:
            raise FileNotFoundError(f"no checkpoint-{epoch}.pt, .msgpack, .dcp or .orbax "
                                    f"in {exp_dir}")
        path = found[0]
    params = load_checkpoint_params(path, use_ema=args.use_ema, device=device)
    if not path.endswith(".orbax"):
        params = fit_template(params, args.width_mult)
    out = args.out or os.path.join(exp_dir, f"checkpoint-{epoch}.tar")
    save_reference_checkpoint(out, params, epoch=epoch)
    print(f"wrote {out} (epoch {epoch}{', EMA weights' if args.use_ema else ''})")
    return out


if __name__ == "__main__":
    main()
