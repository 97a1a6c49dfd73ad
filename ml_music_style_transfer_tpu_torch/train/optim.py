"""The optimizer options of ``TrainConfig``: the JAX package's
``train/optim.py`` and the optax chain its ``Trainer`` builds
(``train/loop.py:93-129``), on a model's parameters in place.

With no option set the ``Trainer`` keeps ``torch.optim.Adam`` (fused on the
card), as before. With any option set it builds a ``TrainOptimizer``, which
computes what the JAX package's transform does, in the same order:

    MultiSteps(chain(clip_by_global_norm, inject_hyperparams(adam),
                     scale_by_schedule(warmup), param_ema), grad_accum)

  - ``grads_dtype``: each gradient makes a round trip through that dtype
    after the backward, per microbatch (JAX ``loop.py:157-164``);
  - ``grad_accum = k``: a float32 running mean ``acc + (g - acc) / (n + 1)``
    over k microbatches (``optax.MultiSteps``); the first k - 1 calls leave
    the parameters untouched, the k-th applies the rest of the chain to the
    mean;
  - ``grad_clip_norm``: optax's ``clip_by_global_norm``, ``g`` where
    ``|g| < max`` else ``(g / |g|) * max`` (not torch's
    ``clip_grad_norm_``, which divides by ``|g| + 1e-6``);
  - Adam: ``torch.optim.Adam`` where both moments are float32, else
    ``CompactAdam`` (the JAX ``scale_by_adam_compact``), whose moments are
    stored in ``adam_mu_dtype``/``adam_nu_dtype`` and whose arithmetic is
    float32; then the learning-rate scale;
  - ``warmup_steps = w``: the update times ``min(1, (c + 1) / w)``, where c
    counts applied updates (``optax.scale_by_schedule``);
  - ``ema_decay = d``: ``ParamEma``, a float32 EMA of the parameters after
    each applied update, ``d * e + (1 - d) * p`` (JAX ``param_ema``).

``state_dict`` of a ``TrainOptimizer`` is the chain's state in optax's
terms (``export_state``), keyed by parameter name; ``compat/weights.py``
translates it to and from the optax state tree of a flax msgpack file.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import TrainConfig

B1, B2, EPS = 0.9, 0.999, 1e-8
CHUNK_ELEMENTS = 1 << 26  # CompactAdam's float32 temporaries: 4 x 256 MB at most


def storage_dtype(name: str | None) -> torch.dtype | None:
    """A moment or gradient dtype option as a torch dtype; None where the
    option leaves float32 (unset, or 'float32')."""
    if name is None or name == "float32":
        return None
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def has_options(cfg: TrainConfig) -> bool:
    """True where ``cfg`` asks for more than plain float32 Adam."""
    return any((storage_dtype(cfg.adam_mu_dtype), storage_dtype(cfg.adam_nu_dtype),
                storage_dtype(cfg.grads_dtype), cfg.grad_clip_norm is not None,
                cfg.warmup_steps > 0, cfg.ema_decay is not None, cfg.grad_accum > 1))


def arith_dtype(param_dtype: torch.dtype) -> torch.dtype:
    """The optimizer's arithmetic dtype: float32, or float64 for float64
    parameters (the tests' float64 yardstick)."""
    return torch.promote_types(param_dtype, torch.float32)


def _f32(x: float) -> float:
    """``x`` rounded to float32: optax's injected hyperparameters are
    float32 arrays, so 1 - b1 is computed in float32."""
    return float(np.float32(x))


def _chunks(params: list, limit: int = CHUNK_ELEMENTS) -> list[slice]:
    out, lo, n = [], 0, 0
    for i, p in enumerate(params):
        if n and n + p.numel() > limit:
            out.append(slice(lo, i))
            lo, n = i, 0
        n += p.numel()
    out.append(slice(lo, len(params)))
    return out


class CompactAdam:
    """Adam whose moments are stored in ``mu_dtype``/``nu_dtype`` (None:
    the parameters' dtype) while every operation runs in float32 (JAX
    ``optim.scale_by_adam_compact``, ``:25-60``), then the learning-rate
    scale. The update uses the float32 moments before they are rounded for
    storage; storage is cast once, on write. With both dtypes None it is
    ``optax.scale_by_adam`` with ``optax.scale_by_learning_rate``.

    It runs over the parameters in slices of at most ``CHUNK_ELEMENTS``
    elements, so its float32 temporaries stay small beside the model."""

    def __init__(self, params, lr: float, mu_dtype: torch.dtype | None = None,
                 nu_dtype: torch.dtype | None = None, b1: float = B1, b2: float = B2,
                 eps: float = EPS):
        self.params = list(params)
        self.param_groups = [{"lr": lr}]
        self.b1, self.b2, self.eps = _f32(b1), _f32(b2), _f32(eps)
        self.c1 = float(np.float32(1) - np.float32(b1))
        self.c2 = float(np.float32(1) - np.float32(b2))
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=nu_dtype or p.dtype) for p in self.params]
        self._slices = _chunks(self.params)
        self._arith = arith_dtype(self.params[0].dtype)

    @torch.no_grad()
    def step(self, warmup: float | None = None) -> None:
        """One update from the parameters' ``.grad``: the Adam direction
        times -lr (times ``warmup`` where given), added to the parameters."""
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        lr = self.param_groups[0]["lr"]
        for sl in self._slices:
            params, grads = self.params[sl], [p.grad for p in self.params[sl]]
            mu, nu = self.mu[sl], self.nu[sl]
            # the stored moments in the arithmetic dtype: the stored tensor
            # itself where it has that dtype, else a copy
            dt = self._arith
            mu32 = [m.to(dt) for m in mu]
            nu32 = [v.to(dt) for v in nu]
            torch._foreach_mul_(mu32, self.b1)
            torch._foreach_add_(mu32, grads, alpha=self.c1)
            torch._foreach_mul_(nu32, self.b2)
            torch._foreach_addcmul_(nu32, grads, grads, value=self.c2)
            u = torch._foreach_div(mu32, bc1)
            den = torch._foreach_div(nu32, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(u, den)
            del den
            for stored, new in ((mu, mu32), (nu, nu32)):
                if stored[0].dtype != dt:
                    torch._foreach_copy_(stored, new)  # the one rounding
            torch._foreach_mul_(u, -_f32(lr))
            if warmup is not None:
                torch._foreach_mul_(u, warmup)
            torch._foreach_add_(params, u)

    def moments(self) -> tuple[int, list, list]:
        return self.count, self.mu, self.nu

    def load_moments(self, count: int, mu: list, nu: list) -> None:
        self.count = int(count)
        for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
            dst.copy_(src)


def adam_moments(opt: torch.optim.Adam) -> tuple[int, list, list]:
    """(count, first moments, second moments) of a ``torch.optim.Adam`` in
    its parameters' order; zeros before its first step."""
    params = opt.param_groups[0]["params"]
    if not opt.state.get(params[0]):
        return 0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    st = [opt.state[p] for p in params]
    return (int(st[0]["step"]), [s["exp_avg"] for s in st], [s["exp_avg_sq"] for s in st])


def load_adam_moments(opt: torch.optim.Adam, count: int, mu: list, nu: list) -> None:
    """Give a ``torch.optim.Adam`` the state of ``count`` steps with these
    moments (the optax Adam state of a JAX checkpoint)."""
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
                   for i, (m, v) in enumerate(zip(mu, nu))}
    opt.load_state_dict(sd)


class ParamEma:
    """A float32 EMA of the parameters, initialised from them (JAX
    ``optim.param_ema``, ``:71-92``). ``update`` folds in the parameters
    after an applied update: ``decay * e + (1 - decay) * p``."""

    def __init__(self, params, decay: float):
        self.params = list(params)
        self.decay = decay
        self.ema = [p.detach().to(arith_dtype(p.dtype), copy=True) for p in self.params]

    @torch.no_grad()
    def update(self) -> None:
        torch._foreach_mul_(self.ema, _f32(self.decay))
        torch._foreach_add_(self.ema, self.params, alpha=_f32(1.0 - self.decay))


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float, norm_fn=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: unchanged where the global
    L2 norm is below ``max_norm``, else ``(g / norm) * max_norm``. The
    choice is made on the device (no host sync). ``norm_fn(grads)`` gives
    the norm where ``grads`` are shards (ZeRO). Returns the norm."""
    if norm_fn is not None:
        norm = norm_fn(grads)
    else:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


class TrainOptimizer:
    """The JAX ``Trainer``'s optax transform with its options
    (module docstring), updating named parameters in place. ``step``
    returns whether it applied an update (False on the first k - 1
    microbatches of a ``grad_accum = k`` cycle). ``param_groups[0]["lr"]``
    is the injected learning rate: ``Trainer.set_lr`` and the plateau
    scheduler write it."""

    def __init__(self, named_params, cfg: TrainConfig, lr: float, fused: bool = False,
                 norm_fn=None):
        named = list(named_params)
        self.norm_fn = norm_fn
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.param_groups = [{"lr": lr}]
        self.grads_dtype = storage_dtype(cfg.grads_dtype)
        self.clip = cfg.grad_clip_norm
        self.warmup_steps = cfg.warmup_steps
        self.warmup_count = 0
        self.k = cfg.grad_accum
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p, dtype=arith_dtype(p.dtype)) for p in self.params]
                    if self.k > 1 else None)
        mu_dt, nu_dt = storage_dtype(cfg.adam_mu_dtype), storage_dtype(cfg.adam_nu_dtype)
        if mu_dt is None and nu_dt is None:
            self.adam = torch.optim.Adam(self.params, lr=lr, betas=(B1, B2), eps=EPS,
                                         fused=True if fused else None)
        else:
            self.adam = CompactAdam(self.params, lr, mu_dt, nu_dt)
        self.ema = ParamEma(self.params, cfg.ema_decay) if cfg.ema_decay is not None else None

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Drops every gradient (``set_to_none``, the only way the Trainer
        clears them)."""
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        grads = [p.grad for p in self.params]
        if self.grads_dtype is not None:
            for g in grads:
                g.copy_(g.to(self.grads_dtype))
        if self.acc is not None:
            d = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(d, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, d)
            del d
            self.mini_step = (self.mini_step + 1) % self.k
            if self.mini_step:
                return False
            grads = self.acc
            for p, a in zip(self.params, self.acc):
                p.grad = a
        if self.clip is not None:
            clip_by_global_norm_(grads, self.clip, self.norm_fn)
        warm = None
        if self.warmup_steps > 0:
            warm = float(min(np.float32(1), np.float32(self.warmup_count + 1)
                             / np.float32(self.warmup_steps)))
            self.warmup_count += 1
        lr = self.param_groups[0]["lr"]
        if isinstance(self.adam, CompactAdam):
            self.adam.param_groups[0]["lr"] = lr
            self.adam.step(warm)
        else:
            self.adam.param_groups[0]["lr"] = lr * (1.0 if warm is None else warm)
            self.adam.step()
        if self.ema is not None:
            self.ema.update()
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True

    def moments(self) -> tuple[int, list, list]:
        if isinstance(self.adam, CompactAdam):
            return self.adam.moments()
        return adam_moments(self.adam)

    def state_dict(self) -> dict:
        return export_state(self, self.names)

    def load_state_dict(self, state: dict) -> None:
        import_state(self, state, self.names)


def build_optimizer(named_params, cfg: TrainConfig, lr: float, device: torch.device,
                    norm_fn=None):
    """``torch.optim.Adam`` (lr, betas (0.9, 0.999), eps 1e-8, optax's
    defaults; fused on the card) where ``cfg`` sets no option, else a
    ``TrainOptimizer``."""
    fused = device.type == "cuda"
    if has_options(cfg):
        return TrainOptimizer(named_params, cfg, lr, fused=fused, norm_fn=norm_fn)
    return torch.optim.Adam([p for _, p in named_params], lr=lr, betas=(B1, B2), eps=EPS,
                            fused=True if fused else None)


class ZeroOptimizer:
    """ZeRO-1 over the batch axes' process group (the JAX ``Trainer``'s
    ``zero_opt``, ``train/loop.py:231-244``): the optimizer state of each
    parameter is kept for this rank's slice of it only, the slice along
    ``parallel/mesh.zero_extend`` (its largest dim the group size divides;
    a parameter with none is kept whole on every rank). ``step`` takes the
    slices of the current parameters and of their (already summed)
    gradients, updates them with the same optimizer and options as one
    device, then gathers the whole updated parameters on every rank. Adam
    is elementwise, so a step equals the unsharded step bit for bit: the
    gradient dtype's round trip and the clipping norm are taken on the
    whole gradients, as one device takes them (under ``grad_accum`` the
    norm of the mean is summed from the slices of the accumulator, which
    is sliced like the moments and the EMA).

    ``state_dict`` gathers the whole state (a collective: every rank calls
    it), and ``load_state_dict`` takes a whole state and keeps this rank's
    slices."""

    def __init__(self, named_params, cfg: TrainConfig, lr: float, device: torch.device,
                 group):
        from ..parallel import comm, mesh as pmesh

        import dataclasses

        named = list(named_params)
        self.group = group
        self.n, self.rank = comm.group_size(group), comm.group_rank(group)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.dims = [pmesh.zero_extend(p.shape, self.n) for p in self.params]
        self.shards = [torch.nn.Parameter(self._slice(p.detach(), d).clone())
                       for p, d in zip(self.params, self.dims)]
        self.grads_dtype = storage_dtype(cfg.grads_dtype)
        self._whole_grads = None
        self.inner = build_optimizer(list(zip(self.names, self.shards)),
                                     dataclasses.replace(cfg, grads_dtype=None), lr, device,
                                     norm_fn=self.norm)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _slice(self, t: torch.Tensor, dim: int | None) -> torch.Tensor:
        if dim is None:
            return t
        size = t.shape[dim] // self.n
        return t.narrow(dim, self.rank * size, size)

    def _gather(self, t: torch.Tensor, dim: int | None) -> torch.Tensor:
        from ..parallel import comm

        return t if dim is None else comm.all_gather_cat(t, self.group, dim)

    @torch.no_grad()
    def norm(self, grads: list) -> torch.Tensor:
        """The global L2 norm of gradients given as this rank's slices:
        one device's norm of the whole gradients where ``step`` has them,
        else the sliced ones' squares summed over the group and the whole
        ones' added once."""
        from ..parallel import comm

        if self._whole_grads is not None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(self._whole_grads)))
        sq = [torch.zeros((), dtype=torch.float64, device=grads[0].device) for _ in range(2)]
        for g, d in zip(grads, self.dims):
            sq[d is None] += g.double().square().sum()
        return torch.sqrt(comm.all_reduce_(sq[0], self.group) + sq[1]).to(grads[0].dtype)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params + self.shards:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        grads = [p.grad for p in self.params]
        if self.grads_dtype is not None:
            for g in grads:
                g.copy_(g.to(self.grads_dtype))
        accumulating = isinstance(self.inner, TrainOptimizer) and self.inner.acc is not None
        self._whole_grads = None if accumulating else grads
        for p, s, d in zip(self.params, self.shards, self.dims):
            s.copy_(self._slice(p, d))  # the parameters may have been loaded since
            s.grad = self._slice(p.grad, d).contiguous()
        applied = self.inner.step()
        self._whole_grads = None
        if applied is False:
            return False
        for p, s, d in zip(self.params, self.shards, self.dims):
            p.copy_(self._gather(s, d))
        return True

    def gathered(self, tensors: list) -> list:
        """Whole tensors from per-parameter slices (a collective)."""
        return [self._gather(t, d) for t, d in zip(tensors, self.dims)]

    def sliced(self, tensors: list) -> list:
        """This rank's slices of whole per-parameter tensors."""
        return [self._slice(t, d).contiguous() for t, d in zip(tensors, self.dims)]

    def state_dict(self) -> dict:
        return export_state(self, self.names)

    def load_state_dict(self, state: dict) -> None:
        import_state(self, state, self.names)


def _zero_map(state: dict, names: list[str], fn) -> dict:
    """``state`` (``export_state``'s layout) with ``fn`` applied to each of
    its per-parameter lists (mu, nu, ema, acc)."""
    out = dict(state)
    for key in ("mu", "nu", "ema", "acc"):
        if state.get(key) is not None:
            out[key] = dict(zip(names, fn([state[key][n] for n in names])))
    return out


def export_state(opt, names: list[str]) -> dict:
    """The optimizer's state in optax's terms, tensors keyed by parameter
    name: ``lr``, Adam's ``count``, ``mu``, ``nu``; ``warmup_count``,
    ``ema``, ``acc`` and ``mini_step`` (None where the option is off)."""
    if isinstance(opt, ZeroOptimizer):
        return _zero_map(export_state(opt.inner, names), names, opt.gathered)
    if isinstance(opt, TrainOptimizer):
        count, mu, nu = opt.moments()
        return {"lr": opt.param_groups[0]["lr"], "count": count,
                "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu)),
                "warmup_count": opt.warmup_count if opt.warmup_steps > 0 else None,
                "ema": dict(zip(names, opt.ema.ema)) if opt.ema is not None else None,
                "acc": dict(zip(names, opt.acc)) if opt.acc is not None else None,
                "mini_step": opt.mini_step if opt.acc is not None else None}
    count, mu, nu = adam_moments(opt)
    return {"lr": opt.param_groups[0]["lr"], "count": count, "mu": dict(zip(names, mu)),
            "nu": dict(zip(names, nu)), "warmup_count": None, "ema": None, "acc": None,
            "mini_step": None}


@torch.no_grad()
def import_state(opt, state: dict, names: list[str]) -> None:
    """Load an ``export_state`` dict (from a .pt or translated from a JAX
    msgpack) into ``opt``. The options present must be the optimizer's:
    a mismatch raises ``ValueError``, as flax's restore raises on a tree of
    another layout."""
    if isinstance(opt, ZeroOptimizer):
        import_state(opt.inner, _zero_map(state, names, opt.sliced), names)
        return
    is_chain = isinstance(opt, TrainOptimizer)
    have = {"warmup_count": is_chain and opt.warmup_steps > 0,
            "ema": is_chain and opt.ema is not None,
            "acc": is_chain and opt.acc is not None}
    for key, on in have.items():
        if (state.get(key) is not None) != on:
            raise ValueError(f"the checkpoint's optimizer state {'lacks' if on else 'has'} "
                             f"'{key}': it was trained with other optimizer options")
    mu = [state["mu"][n] for n in names]
    nu = [state["nu"][n] for n in names]
    opt.param_groups[0]["lr"] = float(state["lr"])
    if not is_chain:
        load_adam_moments(opt, state["count"], mu, nu)
        return
    if isinstance(opt.adam, CompactAdam):
        opt.adam.load_moments(state["count"], mu, nu)
    else:
        load_adam_moments(opt.adam, state["count"], mu, nu)
    if have["warmup_count"]:
        opt.warmup_count = int(state["warmup_count"])
    if have["ema"]:
        for e, n in zip(opt.ema.ema, names):
            e.copy_(state["ema"][n])
    if have["acc"]:
        for a, n in zip(opt.acc, names):
            a.copy_(state["acc"][n])
        opt.mini_step = int(state["mini_step"])


def get_param_ema(opt) -> list[torch.Tensor]:
    """The EMA of the parameters, in their order (JAX ``get_param_ema``);
    whole tensors under ZeRO (a collective)."""
    if isinstance(opt, ZeroOptimizer):
        return opt.gathered(get_param_ema(opt.inner))
    if not isinstance(opt, TrainOptimizer) or opt.ema is None:
        raise ValueError("the optimizer keeps no parameter EMA: was ema_decay set?")
    return opt.ema.ema
