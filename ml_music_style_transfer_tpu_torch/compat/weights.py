"""Weights across frameworks: flax param trees and reference ``.tar`` files
-> the port's ``state_dict``.

The port's module names are the reference's ``state_dict`` keys, so a
reference checkpoint is already a port state_dict. A flax PerformanceNet
tree (the JAX package's) needs its key map and layout transposes; this is
the port's own copy of the JAX package's ``compat/torch_export.py:32-63``:
  - Conv kernel (k, in, out)          -> Conv1d weight (out, in, k)
  - ConvTranspose kernel (k, in, out) -> ConvTranspose1d weight (in, out, k)
  - Dense kernel (in, out)            -> Linear weight (out, in)
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _conv_w(k) -> np.ndarray:
    return np.asarray(k).transpose(2, 1, 0)  # (k,in,out) -> (out,in,k)


def _convT_w(k) -> np.ndarray:
    return np.asarray(k).transpose(1, 2, 0)  # (k,in,out) -> (in,out,k)


def _lin_w(k) -> np.ndarray:
    return np.asarray(k).T  # (in,out) -> (out,in)


# (regex on the flattened flax module path, torch key template, kernel transform)
_RULES = [
    (re.compile(r"^midi_down_(\d+)/Conv1x3_([01])/Conv_0$"),
     lambda m: f"down_convs.{m.group(1)}.conv{int(m.group(2)) + 1}", _conv_w),
    (re.compile(r"^audio_down_(\d+)/Conv1x3_([01])/Conv_0$"),
     lambda m: f"down_convs_audio.{m.group(1)}.conv{int(m.group(2)) + 1}", _conv_w),
    (re.compile(r"^onset_offset_encoder/down_(\d+)/Conv1x3_([01])/Conv_0$"),
     lambda m: f"onset_offset_encoder.down_convs.{m.group(1)}.conv{int(m.group(2)) + 1}",
     _conv_w),
    (re.compile(r"^dense_concat_(\d+)/Dense_([01])$"),
     lambda m: f"dense_concats.{m.group(1)}.fc{int(m.group(2)) + 1}", _lin_w),
    (re.compile(r"^up_(\d+)/ConvTranspose1dTorch_0$"),
     lambda m: f"up_convs.{m.group(1)}.upconv", _convT_w),
    (re.compile(r"^up_(\d+)/Conv1x3_([01])/Conv_0$"),
     lambda m: f"up_convs.{m.group(1)}.conv{int(m.group(2)) + 1}", _conv_w),
    (re.compile(r"^mbr_(\d+)/conv([12])_(\d+)/Conv_0$"),
     lambda m: f"MBRBlock{int(m.group(1)) + 1}.conv_list{m.group(2)}.{m.group(3)}",
     _conv_w),
    (re.compile(r"^lastconv$"), lambda m: "lastconv", _convT_w),
]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax PerformanceNet params (nested dicts of numpy arrays, with or
    without the ``'params'`` wrapper) -> the port's float32 state_dict.

    Unmapped module paths raise KeyError, so a partial translation can never
    load silently.
    """
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    modules: Dict[str, Dict[str, Any]] = {}
    for path, leaf in _flatten(tree).items():
        base, name = path.rsplit("/", 1)
        modules.setdefault(base, {})[name] = leaf
    state: Dict[str, torch.Tensor] = {}
    for base, leaves in modules.items():
        for rx, key_fn, w_transform in _RULES:
            m = rx.match(base)
            if m:
                key = key_fn(m)
                # np.array copies: arrays from jax are read-only views
                state[f"{key}.weight"] = torch.from_numpy(np.array(
                    w_transform(leaves["kernel"]), dtype=np.float32, order="C"))
                state[f"{key}.bias"] = torch.from_numpy(np.array(
                    leaves["bias"], dtype=np.float32, order="C"))
                break
        else:
            raise KeyError(f"unmapped flax param module: {base}")
    return state


def load_reference_checkpoint(path: str, compat_mbr_noop: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """A reference ``checkpoint-{epoch}.tar`` -> the port's state_dict.

    ``compat_mbr_noop=True`` drops the MBR conv weights: the reference never
    trains them (its MBRBlock discards the residual, model.py:172) and the
    port's compat MBRBlock has no parameters.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return {k: v.float() for k, v in state.items()
            if not (compat_mbr_noop and k.startswith("MBRBlock"))}
