"""Weights and optimizer state across frameworks: flax param trees, optax
state trees and reference ``.tar`` files <-> the port's ``state_dict``.

The port's module names are the reference's ``state_dict`` keys, so a
reference checkpoint is already a port state_dict. A flax PerformanceNet
tree (the JAX package's) needs its key map and layout transposes; this is
the port's own copy of the JAX package's ``compat/torch_export.py:32-63``:
  - Conv kernel (k, in, out)          <-> Conv1d weight (out, in, k)
  - ConvTranspose kernel (k, in, out) <-> ConvTranspose1d weight (in, out, k)
  - Dense kernel (in, out)            <-> Linear weight (out, in)
Each map runs both ways (``from_jax_params``, ``to_jax_params``);
``AUTOENCODER`` is the map of the autoencoder family. Reference ``.tar``
files are read (``load_reference_checkpoint``) and written
(``save_reference_checkpoint``, the counterpart of the JAX package's
``compat/torch_export.py:84-117``).

``from_jax_opt_state`` reads the optax state tree that the JAX ``Trainer``
checkpoints (``inject_hyperparams(adam)``, alone or in a ``chain`` with
``clip_by_global_norm``, ``scale_by_schedule`` and ``param_ema``, inside
``MultiSteps`` where ``grad_accum > 1``; flax writes named tuples as
dicts of their fields and tuples as dicts keyed "0", "1", ...) into the
port's optimizer state (``train/optim.export_state``);
``to_jax_opt_state`` writes the tree the JAX ``Trainer`` of a given
``TrainConfig`` restores, in optax's structure: named tuples as dicts of
their fields, sequences (a ``chain``'s states, adam's inner chain) as
tuples, optax's ``EmptyState`` as ``None``, ``MultiSteps``' empty
``skip_state`` as ``()``. The orbax writer records that structure (what
orbax records of the JAX ``Trainer``'s state); ``flax_state_dict`` gives
flax's state-dict layout of it (what flax msgpack holds). ``to_jax_state``
translates a whole checkpoint state; its ``leaf`` argument translates
other leaves than tensors too, such as one rank's slices of them (a
permutation of a slice is a slice of the permuted whole).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import TrainConfig

# layout transposes, flax -> torch and torch -> flax
_TO_TORCH = {"conv": lambda t: t.permute(2, 1, 0), "convT": lambda t: t.permute(1, 2, 0),
             "lin": lambda t: t.t()}
TO_FLAX_DIMS = {"conv": (2, 1, 0), "convT": (2, 0, 1), "lin": (1, 0)}
_TO_FLAX = {k: (lambda t, d=d: t.permute(d)) for k, d in TO_FLAX_DIMS.items()}


def _flax_leaf(t: torch.Tensor, dims) -> torch.Tensor:
    """``to_jax_params``' default ``leaf``: ``t`` permuted to ``dims``
    (None: as it is), detached and contiguous."""
    return (t if dims is None else t.permute(dims)).detach().contiguous()

# (regex on the flax module path, its torch key; regex on the torch key,
# its flax path; layout)
PERFORMANCE_NET = [
    (r"^midi_down_(\d+)/Conv1x3_([01])/Conv_0$", lambda m: f"down_convs.{m[1]}.conv{int(m[2]) + 1}",
     r"^down_convs\.(\d+)\.conv([12])$", lambda m: f"midi_down_{m[1]}/Conv1x3_{int(m[2]) - 1}/Conv_0",
     "conv"),
    (r"^audio_down_(\d+)/Conv1x3_([01])/Conv_0$",
     lambda m: f"down_convs_audio.{m[1]}.conv{int(m[2]) + 1}",
     r"^down_convs_audio\.(\d+)\.conv([12])$",
     lambda m: f"audio_down_{m[1]}/Conv1x3_{int(m[2]) - 1}/Conv_0", "conv"),
    (r"^onset_offset_encoder/down_(\d+)/Conv1x3_([01])/Conv_0$",
     lambda m: f"onset_offset_encoder.down_convs.{m[1]}.conv{int(m[2]) + 1}",
     r"^onset_offset_encoder\.down_convs\.(\d+)\.conv([12])$",
     lambda m: f"onset_offset_encoder/down_{m[1]}/Conv1x3_{int(m[2]) - 1}/Conv_0", "conv"),
    (r"^dense_concat_(\d+)/Dense_([01])$", lambda m: f"dense_concats.{m[1]}.fc{int(m[2]) + 1}",
     r"^dense_concats\.(\d+)\.fc([12])$", lambda m: f"dense_concat_{m[1]}/Dense_{int(m[2]) - 1}",
     "lin"),
    (r"^up_(\d+)/ConvTranspose1dTorch_0$", lambda m: f"up_convs.{m[1]}.upconv",
     r"^up_convs\.(\d+)\.upconv$", lambda m: f"up_{m[1]}/ConvTranspose1dTorch_0", "convT"),
    (r"^up_(\d+)/Conv1x3_([01])/Conv_0$", lambda m: f"up_convs.{m[1]}.conv{int(m[2]) + 1}",
     r"^up_convs\.(\d+)\.conv([12])$", lambda m: f"up_{m[1]}/Conv1x3_{int(m[2]) - 1}/Conv_0",
     "conv"),
    (r"^mbr_(\d+)/conv([12])_(\d+)/Conv_0$",
     lambda m: f"MBRBlock{int(m[1]) + 1}.conv_list{m[2]}.{m[3]}",
     r"^MBRBlock(\d+)\.conv_list([12])\.(\d+)$",
     lambda m: f"mbr_{int(m[1]) - 1}/conv{m[2]}_{m[3]}/Conv_0", "conv"),
    (r"^lastconv$", lambda m: "lastconv", r"^lastconv$", lambda m: "lastconv", "convT"),
]

# models/autoencoder.py: the modules carry the flax module names
AUTOENCODER = [
    (r"^(down_0|down_1|bottleneck)/Conv1x3_([01])/Conv_0$", lambda m: f"{m[1]}.conv{int(m[2]) + 1}",
     r"^(down_0|down_1|bottleneck)\.conv([12])$", lambda m: f"{m[1]}/Conv1x3_{int(m[2]) - 1}/Conv_0",
     "conv"),
    (r"^(up_0|up_1)$", lambda m: m[1], r"^(up_0|up_1)$", lambda m: m[1], "convT"),
    (r"^head/Conv_0$", lambda m: "head", r"^head$", lambda m: "head/Conv_0", "conv"),
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


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.array(leaf)  # a copy: arrays from jax are read-only
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_params(tree: Mapping[str, Any], rules=PERFORMANCE_NET, keep_dtype: bool = False,
                    device=None) -> Dict[str, torch.Tensor]:
    """A flax param tree (nested dicts of numpy arrays or torch tensors,
    with or without the ``'params'`` wrapper) -> the port's state_dict, in
    float32 unless ``keep_dtype``. With ``device`` each leaf goes there
    before its transpose (on the card, the transposes run there).

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
        for rx, key_fn, _, _, kind in rules:
            m = re.match(rx, base)
            if m:
                key = key_fn(m)
                for name, tf in (("weight", _TO_TORCH[kind]), ("bias", lambda t: t)):
                    t = _tensor(leaves["kernel" if name == "weight" else "bias"])
                    t = tf(t.to(device) if device is not None else t)
                    if not keep_dtype:
                        t = t.float()
                    state[f"{key}.{name}"] = t.contiguous()
                break
        else:
            raise KeyError(f"unmapped flax param module: {base}")
    return state


def to_jax_params(state: Mapping[str, Any], rules=PERFORMANCE_NET, leaf=_flax_leaf) -> dict:
    """The port's state_dict (or any tree of tensors keyed by its names,
    e.g. Adam moments) -> a flax param tree ``{"params": {...}}`` of
    contiguous tensors in the flax layout, on the tensors' device and in
    their dtype. ``leaf(value, dims)`` makes each flax leaf: ``dims`` is
    the permutation from the torch layout (None for a bias). Unmapped keys
    raise KeyError."""
    out: dict = {}
    for key, t in state.items():
        base, name = key.rsplit(".", 1)
        for _, _, rx, path_fn, kind in rules:
            m = re.match(rx, base)
            if m:
                node = out
                for part in path_fn(m).split("/"):
                    node = node.setdefault(part, {})
                node["kernel" if name == "weight" else "bias"] = leaf(
                    t, TO_FLAX_DIMS[kind] if name == "weight" else None)
                break
        else:
            raise KeyError(f"unmapped port param: {key}")
    return {"params": out}


def _i32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def flax_state_dict(tree):
    """An optax-structured tree (``to_jax_opt_state``'s, or a whole state
    holding one) in flax's state-dict layout, what flax msgpack holds and
    ``orbax_format.read`` returns: tuples and lists as dicts keyed "0",
    "1", ...; ``None`` (optax's ``EmptyState``) as ``{}``. Dicts keep their
    order; other leaves are kept as they are."""
    if isinstance(tree, (tuple, list)):
        return {str(i): flax_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, Mapping):
        return {k: flax_state_dict(v) for k, v in tree.items()}
    return {} if tree is None else tree


def from_jax_opt_state(tree: Mapping[str, Any], rules=PERFORMANCE_NET) -> dict:
    """The optax state tree of a JAX ``Trainer`` checkpoint (flax's
    state-dict layout, or ``to_jax_opt_state``'s optax structure) -> the
    port's optimizer state (``train/optim.export_state``: lr, Adam count,
    mu, nu, warmup count, EMA, accumulator, mini-step), tensors keyed by
    the port's parameter names in their stored dtypes."""
    tree = flax_state_dict(tree)
    params = lambda t: from_jax_params(t, rules, keep_dtype=True)  # noqa: E731
    out = {"lr": None, "count": 0, "mu": None, "nu": None, "warmup_count": None, "ema": None,
           "acc": None, "mini_step": None}
    if "mini_step" in tree:  # optax.MultiSteps
        out["mini_step"] = int(tree["mini_step"])
        out["acc"] = params(tree["acc_grads"])
        tree = tree["inner_opt_state"]
    parts = [tree] if "hyperparams" in tree else [tree[str(i)] for i in range(len(tree))]
    for part in parts:
        if "hyperparams" in part:  # inject_hyperparams(adam)
            out["lr"] = float(part["hyperparams"]["learning_rate"])
            adam = part["inner_state"]["0"]
            out["count"] = int(adam["count"])
            out["mu"], out["nu"] = params(adam["mu"]), params(adam["nu"])
        elif set(part) == {"count"}:  # scale_by_schedule (warmup)
            out["warmup_count"] = int(part["count"])
        elif set(part) == {"ema"}:  # param_ema
            out["ema"] = params(part["ema"])
        elif part:  # clip_by_global_norm's state is empty
            raise ValueError(f"unknown optax state with fields {sorted(part)}")
    if out["lr"] is None:
        raise ValueError("no inject_hyperparams(adam) state in the optax tree")
    return out


def to_jax_opt_state(state: Mapping[str, Any], cfg: TrainConfig, rules=PERFORMANCE_NET,
                     leaf=_flax_leaf) -> dict:
    """The port's optimizer state -> the optax state tree that the JAX
    ``Trainer`` built from ``cfg`` restores (the structure of its
    ``self.tx``'s state: named tuples as dicts of their fields, sequences
    as tuples, ``EmptyState`` as None, ``MultiSteps``' ``skip_state`` as
    ``()``): scalars as 0-d int32/float32 arrays, trees in the flax layout
    (``to_jax_params`` with ``leaf``). ``optax.adam`` injects ``eps_root``
    too; ``adam_compact`` (``cfg.adam_nu_dtype`` set) does not."""
    params = lambda d: to_jax_params(d, rules, leaf)  # noqa: E731
    hyper = {"b1": _f32(0.9), "b2": _f32(0.999), "eps": _f32(1e-8)}
    if cfg.adam_nu_dtype is None:
        hyper["eps_root"] = _f32(0.0)
    hyper["learning_rate"] = _f32(state["lr"])
    # inject_hyperparams' state; its inner state is adam's chain of
    # (scale_by_adam, scale_by_learning_rate), the second an EmptyState
    base = {"count": _i32(state["count"]), "hyperparams": hyper, "hyperparams_states": {},
            "inner_state": ({"count": _i32(state["count"]), "mu": params(state["mu"]),
                             "nu": params(state["nu"])}, None)}
    chain = [None] if cfg.grad_clip_norm is not None else []  # clip_by_global_norm's EmptyState
    chain.append(base)
    if cfg.warmup_steps > 0:
        chain.append({"count": _i32(state["warmup_count"])})
    if cfg.ema_decay is not None:
        chain.append({"ema": params(state["ema"])})
    tx = base if len(chain) == 1 else tuple(chain)
    if cfg.grad_accum > 1:
        tx = {"mini_step": _i32(state["mini_step"]), "gradient_step": _i32(state["count"]),
              "inner_opt_state": tx, "acc_grads": params(state["acc"]), "skip_state": ()}
    return tx


def to_jax_state(state: Mapping[str, Any], cfg: TrainConfig, rules=PERFORMANCE_NET,
                 leaf=_flax_leaf) -> dict:
    """A checkpoint state in the port's layout (``Trainer.state_dict``'s or
    ``sharded_state_dict``'s keys: ``params``, ``opt_state``, ``epoch``,
    ``scheduler``, and ``ema_params`` where the run keeps an EMA) -> the
    JAX ``Trainer``'s state tree for ``cfg`` (``to_jax_params``,
    ``to_jax_opt_state``), each tensor leaf made by ``leaf``."""
    out = {"params": to_jax_params(state["params"], rules, leaf),
           "opt_state": to_jax_opt_state(state["opt_state"], cfg, rules, leaf),
           "epoch": state["epoch"], "scheduler": state["scheduler"]}
    if "ema_params" in state:
        out["ema_params"] = to_jax_params(state["ema_params"], rules, leaf)
    return out


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


def to_state_dict(params: Mapping[str, Any], rules=PERFORMANCE_NET) -> Dict[str, torch.Tensor]:
    """A port state_dict (flat, reference keys) or a flax param tree (nested,
    with or without the ``'params'`` wrapper; numpy arrays or tensors) ->
    the reference's state_dict: contiguous float32 CPU tensors in the torch
    layout. A key or module path that no rule maps raises KeyError, so a
    partly translated checkpoint can never be written."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return {k: v.cpu() for k, v in from_jax_params(params, rules).items()}
    state = {}
    for key, v in params.items():
        base = key.rsplit(".", 1)[0]
        if key.rsplit(".", 1)[-1] not in ("weight", "bias") or not any(
                re.match(r[2], base) for r in rules):
            raise KeyError(f"unmapped port param for export: {key}")
        state[key] = _tensor(v).detach().to("cpu", torch.float32).contiguous()
    return state


def save_reference_checkpoint(path: str, params: Mapping[str, Any], epoch: int = 0) -> str:
    """Write a reference-format ``checkpoint-{epoch}.tar``,
    ``{"epoch", "state_dict", "optimizer": None}``, that the unmodified
    reference model/inference.py loads (its strict ``load_state_dict``
    takes full-width weights only). ``params``: as ``to_state_dict``.
    ``optimizer`` is None, as the JAX package writes it: the reference
    reads it only to resume training."""
    torch.save({"epoch": epoch, "state_dict": to_state_dict(params), "optimizer": None}, path)
    return path
