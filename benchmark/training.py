"""What the two training drivers share: the measured window of steps, the
readings of the program's first steps, and the comparison with the
reference's.

The window calls one step after another, each through the call and feed of
set-up's first steps, until ``seconds`` have passed, then waits for the
card: the rate is every step issued over the time until the last one is
done.

The first three steps run in set-up on the same objects the window then
drives, and are read as they happen: each step's loss, the norm of each
leaf's first gradient as Adam took it (its first moment after one step over
1 - beta1) and the norm of each leaf's change after the third step, before
the fourth moves it. The reference follows the same three steps from the
same seeded weights and batches.
"""
from __future__ import annotations

import gc
import time

import torch

from . import weights
from .reference import steps as ref_steps

CHECK_STEPS = 3


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def first_steps(step, named_params: list, optimizer, make_p0, b1: float) -> dict:
    """Run ``CHECK_STEPS`` steps of ``step()`` (which returns the loss as a
    device scalar) and read them; ``make_p0()`` makes the seeded starting
    weights again."""
    losses, grad = [], None
    for t in range(1, CHECK_STEPS + 1):
        losses.append(step())
        if t == 1:
            grad = {k: leaf_norm(optimizer.state[p]["exp_avg"]) / (1.0 - b1)
                    for k, p in named_params}
    p0 = make_p0()
    change = {k: leaf_norm(p.detach() - p0[k]) for k, p in named_params}
    del p0
    return {"loss": [float(x) for x in losses], "grad": grad, "change": change}


def window(ctx, step, dev: torch.device) -> dict:
    """The measured window: {"steps", "seconds", "t0", "issued": each step's
    issue time}."""
    t0 = ctx.open_window()
    end = t0 + ctx.seconds
    issued = []
    while time.perf_counter() < end:
        ctx.tracer.poll()
        issued.append(time.perf_counter())
        step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctx.close_window()
    return {"steps": len(issued), "seconds": seconds, "t0": t0, "issued": issued}


def release(dev: torch.device) -> int:
    """The memory peak, read before the program's state (already dropped by
    the caller) is given back."""
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return peak


def judge(prog: dict, ref: dict, limits: dict) -> dict:
    gaps = ref_steps.step_gaps(prog, ref)
    return {name: (gaps[name], lim) for name, lim in limits.items()}


def reference(cfg: dict, shapes: dict, w_seed: int, dev, batches_fn, loss_rows, block: int):
    """The reference's three steps, in float32 with TF32 off."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params0 = weights.make(shapes, w_seed, dev)
        opt = {"lr": cfg["learning_rate"], "b1": cfg["adam_b1"], "b2": cfg["adam_b2"],
               "eps": cfg["adam_eps"]}
        return ref_steps.train(params0, batches_fn(), loss_rows, opt, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
