"""Training steps worked out plainly: the batch's spectrograms, the forward
(with DenseConcat's Philox dropout masks) in the configuration's precision,
the loss, the backward and Adam in float32, over blocks of rows where a
batch would not fit beside the state at once.

``train`` returns what the program's run is judged by: each step's loss,
the per-leaf norm of the first step's gradient and of the parameters'
change after the last step.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dsp, nets, philox


def adam_(params: dict, grads: dict, state: dict, t: int, lr: float, b1: float, b2: float,
          eps: float) -> None:
    """One Adam step (Kingma and Ba, with bias correction) in place."""
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def leaf_norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def train(params0: dict, batches: list, loss_rows, opt: dict, block: int) -> dict:
    """``len(batches)`` Adam steps from ``params0``. Each batch is a dict of
    row-indexed tensors; ``loss_rows(params, batch, r0, r1, step)`` returns
    the sum over rows r0..r1 of their per-item losses. The step's loss is
    their mean. Returns {"loss": [per step], "grad": {leaf: norm of step
    1's gradient}, "change": {leaf: norm of params - params0}}."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    state: dict = {}
    out = {"loss": []}
    for t, batch in enumerate(batches, start=1):
        n = next(iter(batch.values())).shape[0]
        total = 0.0
        for r0 in range(0, n, block):
            r1 = min(n, r0 + block)
            part = loss_rows(params, batch, r0, r1, t) / n
            part.backward()
            total += float(part.detach())
        grads = {k: p.grad for k, p in params.items()}
        if t == 1:
            out["grad"] = leaf_norms(grads)
        adam_(params, grads, state, t, opt["lr"], opt["b1"], opt["b2"], opt["eps"])
        for p in params.values():
            p.grad = None
        out["loss"].append(total)
    with torch.no_grad():
        out["change"] = leaf_norms({k: params[k] - params0[k] for k in params})
    return out


# ---- PerformanceNet: L1 on the batch's log-power spectrograms --------------

def pnet_batch(audio_rows, cond_rows, roll, onoff, cfg: dict) -> dict:
    """The batch of one step from float32 audio rows (target, conditioning)
    and the rolls: targets and conditioning as log1p(|STFT|^2) frames."""
    b = audio_rows.shape[0]  # one STFT of the 2B rows, targets first, as gathered
    spec = dsp.log_power_stft(torch.cat([audio_rows, cond_rows]), cfg["n_fft"], cfg["hop"])
    return {"target": spec[:b], "cond": spec[b:], "midi": roll, "onoff": onoff}


def pnet_loss_rows(cfg: dict, seeds: list[int], quant=nets.identity):
    rate = cfg["dropout_rate"]

    def loss_rows(params, batch, r0, r1, t):
        full_b = batch["midi"].shape[0]
        dev = batch["midi"].device

        def masks(call, shape):  # the whole batch's mask, these rows of it
            return philox.mask(seeds[t - 1], call, (full_b,) + tuple(shape[1:]), rate,
                               dev)[r0:r1]

        pred = nets.performancenet(params, cfg, batch["midi"][r0:r1], batch["cond"][r0:r1],
                                   batch["onoff"][r0:r1], masks=masks, quant=quant)
        return (pred - batch["target"][r0:r1]).abs().mean(dim=(1, 2)).sum()

    return loss_rows


# ---- autoencoder: multi-scale spectral loss on mel frames -------------------

def mel_frames(spec: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(B, T, bins) log-power -> (B, T, n_mels) log1p mel power."""
    return torch.log1p(torch.matmul(torch.expm1(spec), bank.T))


def mel_multiscale_rows(pred: torch.Tensor, target: torch.Tensor, scales) -> torch.Tensor:
    """Per-item multi-scale distance (B,): for each k the bands mean-pooled
    k at a time, L1 of the power plus L1 of its log1p; the mean over k."""
    pp, pt = torch.expm1(pred), torch.expm1(target)
    n = pred.shape[-1]
    total = 0.0
    for k in scales:
        a = pp.reshape(*pp.shape[:-1], n // k, k).mean(-1)
        b = pt.reshape(*pt.shape[:-1], n // k, k).mean(-1)
        total = total + (a - b).abs().mean(dim=(1, 2)) + (
            torch.log1p(a) - torch.log1p(b)).abs().mean(dim=(1, 2))
    return total / len(scales)


def ae_loss_rows(cfg: dict, bank: torch.Tensor, quant=nets.identity):
    def loss_rows(params, batch, r0, r1, t):
        with torch.no_grad():
            mel = mel_frames(batch["spec"][r0:r1], bank)
        pred = nets.autoencoder(params, cfg, mel, quant=quant)
        return mel_multiscale_rows(pred, mel, cfg["band_scales"]).sum()

    return loss_rows


def worst_gap(prog: dict[str, float], ref: dict[str, float], leaves) -> float:
    """The largest |prog - ref| over ``leaves``, each against the larger of
    its reference norm and the median leaf's."""
    med = float(np.median([ref[k] for k in leaves]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def moved_leaves(ref_grad: dict[str, float], share: float = 1e-3) -> list[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's norm (a conv bias before
    InstanceNorm has none, and Adam moves it by round-off alone)."""
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= share * med]


def step_gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers a training run is judged by: ``loss_gap``, the largest
    relative gap of a step's loss; ``grad_gap`` and ``change_gap``, the
    worst leaf's gap of the first gradient's norm and of the change's."""
    leaves = moved_leaves(ref["grad"])
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))
    return {"loss_gap": loss, "grad_gap": worst_gap(prog["grad"], ref["grad"], leaves),
            "change_gap": worst_gap(prog["change"], ref["change"], leaves)}
