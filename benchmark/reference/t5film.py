"""Spectrogram Diffusion (notes and context encoders, FiLM decoder) and its
diffusion loss as plain functions of a parameter dict, in the precision the
configuration states, written from the layer equations (Hawthorne et al.
2022, arXiv:2206.05408; T5's layers).

Parameter names are the program's ``state_dict`` (Linear (out, in), no
biases). Numerics follow ``compute_dtype`` (bfloat16): every linear takes
its input and weight in it (``quant`` applied to both first: the identity
for the reference, ``nets.fp8`` for the control), the residual stream and
the parameters are float32, the norms' statistics float32. Attention is
``softmax(q k^T + mask) v`` on the linears' rounded q, k and v, in its own
order: the scores and the products with V are summed in float32 (with TF32
off, which the caller sets) and only the probabilities (before dropout) and
the output are rounded to the compute dtype; the program rounds its scores
too. The masks of K2's dropout come from ``philox``, row block by row block
(``mask_rows``), at the program's call indices: with ``S = 2 + 4 L`` sites an
encoder of L layers, the notes encoder takes 0..S-1, the context encoder S..,
the decoder 2S.. (input; per layer probabilities or self-attention output,
attention output or cross-attention output, FF inner, FF output; output).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp, philox
from .nets import identity

MASK = torch.finfo(torch.float32).min
NOISE_KEY = 0x9E3779B97F4A7C15  # the noise generator's seed: the step's seed xor this


# ---- parameters ---------------------------------------------------------------

def _layer_shapes(s: dict, pre: str, cfg: dict, kinds) -> None:
    d, inner, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    for kind in kinds:
        if kind.endswith("norm"):
            s[f"{pre}.{kind}.weight"] = (d,)
        elif kind.endswith("film"):
            s[f"{pre}.{kind}.weight"] = (2 * d, 4 * d)
        elif kind.endswith("attn"):
            for w in "qkv":
                s[f"{pre}.{kind}.{w}.weight"] = (inner, d)
            s[f"{pre}.{kind}.o.weight"] = (d, inner)
        else:  # ff
            s[f"{pre}.ff.wi_0.weight"] = (ff, d)
            s[f"{pre}.ff.wi_1.weight"] = (ff, d)
            s[f"{pre}.ff.wo.weight"] = (d, ff)


ENCODER_LAYER = ("attn_norm", "attn", "ff_norm", "ff")
DECODER_LAYER = ("self_norm", "self_film", "self_attn", "cross_norm", "cross_attn", "ff_norm",
                 "ff_film", "ff")


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """{parameter name: shape} of the model under ``cfg``."""
    d = cfg["d_model"]
    s: dict[str, tuple[int, ...]] = {"notes.token_embedder.weight": (cfg["vocab_size"], d)}
    for i in range(cfg["num_notes_layers"]):
        _layer_shapes(s, f"notes.layers.{i}", cfg, ENCODER_LAYER)
    s["notes.final_norm.weight"] = (d,)
    s["context.input_proj.weight"] = (d, cfg["input_dims"])
    for i in range(cfg["num_context_layers"]):
        _layer_shapes(s, f"context.layers.{i}", cfg, ENCODER_LAYER)
    s["context.final_norm.weight"] = (d,)
    s["decoder.cond_1.weight"] = (4 * d, d)
    s["decoder.cond_2.weight"] = (4 * d, 4 * d)
    s["decoder.input_proj.weight"] = (d, cfg["input_dims"])
    for i in range(cfg["num_decoder_layers"]):
        _layer_shapes(s, f"decoder.layers.{i}", cfg, DECODER_LAYER)
    s["decoder.final_norm.weight"] = (d,)
    s["decoder.spec_out.weight"] = (cfg["input_dims"], d)
    return s


def init_std(name: str, cfg: dict):
    """T5's initial standard deviation of ``name``: None for a norm weight
    (ones), "xavier" for a linear T5 does not have."""
    leaf = name.split(".")[-2]
    if leaf.endswith("norm"):
        return None
    d, dk, h, ff = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["d_ff"]
    return {"token_embedder": 1.0, "q": (d * dk) ** -0.5, "k": d ** -0.5, "v": d ** -0.5,
            "o": (h * dk) ** -0.5, "wi_0": d ** -0.5, "wi_1": d ** -0.5,
            "wo": ff ** -0.5}.get(leaf, "xavier")


# ---- constants ----------------------------------------------------------------

def position_table(length: int, d: int, device) -> torch.Tensor:
    """T5X's fixed sinusoidal table: sin in the first half, cos in the second."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(d // 2) * (-math.log(10000.0) / (d // 2 - 1)))
    table = np.concatenate([np.sin(pos * div), np.cos(pos * div)], axis=1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def noise_embedding(tau: torch.Tensor, d: int, max_period: float) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                            device=tau.device) / (half - 1))
    arg = tau.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


def alphas_cumprod(steps: int, device) -> torch.Tensor:
    """The cosine schedule's cumulative alphas (``squaredcos_cap_v2``)."""
    t = np.arange(steps + 1, dtype=np.float64) / steps
    abar = np.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    betas = np.minimum(1.0 - abar[1:] / abar[:-1], 0.999)
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32)).to(device)


def mel_bank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangular mel filters over [fmin, fmax]."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = dsp.mel_to_hz(np.linspace(dsp.hz_to_mel(fmin), dsp.hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower, upper = -ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return (weights * (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]).astype(np.float32)


def features(audio: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(..., samples) audio -> (..., frames, n_mels) log-mel magnitude,
    clipped to [log(floor), log_max] and scaled to [-1, 1]."""
    n_fft, hop = cfg["n_fft"], cfg["hop"]
    y = dsp.reflect_pad(audio.float(), n_fft // 2)
    n_frames = 1 + (y.shape[-1] - n_fft) // hop
    frames = y.unfold(-1, n_fft, hop)[..., :n_frames, :]
    mag = torch.fft.rfft(frames * dsp.hann_f64(n_fft, y.device), dim=-1).abs()
    bank = torch.from_numpy(mel_bank(cfg["sr"], n_fft, cfg["input_dims"], cfg["mel_fmin"],
                                     cfg["mel_fmax"])).to(y.device)
    lo, hi = math.log(cfg["log_floor"]), cfg["log_max"]
    m = torch.log(torch.clamp(torch.matmul(mag, bank.T), min=cfg["log_floor"]))
    return (m.clamp(lo, hi) - lo) * (2.0 / (hi - lo)) - 1.0


def noise(seed: int, batch: int, cfg: dict, device):
    """The step's (noise step indices (B,), eps (B, frames, n_mels))."""
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ NOISE_KEY)
    t = torch.randint(0, cfg["num_train_timesteps"], (batch,), generator=gen, device=device)
    eps = torch.randn((batch, cfg["targets_length"], cfg["input_dims"]), generator=gen,
                      device=device)
    return t, eps


def mask_rows(seed: int, call: int, shape, rate: float, r0: int, r1: int, device):
    """``philox.mask(seed, call, shape, rate, device)[r0:r1]``, drawing the
    Philox words of those rows alone."""
    inner = math.prod(int(d) for d in shape[1:])
    e0, e1 = r0 * inner, r1 * inner
    g = torch.arange(e0 // 4, (e1 + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = g & philox.U32, g >> 32
    c2, c3 = torch.full_like(g, int(call)), torch.zeros_like(g)
    k0, k1 = int(seed) & philox.U32, int(seed) >> 32
    for r in range(10):
        if r:
            k0, k1 = (k0 + philox.W[0]) & philox.U32, (k1 + philox.W[1]) & philox.U32
        hi0, lo0 = philox._mulhilo(c0, philox.M[0])
        hi1, lo1 = philox._mulhilo(c2, philox.M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    bits = torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[e0 - 4 * (e0 // 4):][:e1 - e0]
    threshold = max(min(int(round((1.0 - rate) * 2.0**32)), 2**32 - 1), 1) - 1
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    return ((bits <= threshold).to(torch.float32) * scale).reshape((r1 - r0,) + tuple(shape[1:]))


# ---- the network --------------------------------------------------------------

class Net:
    """The layers over ``params``; ``masks(call, shape)`` gives the dropout
    mask of this block's rows (None: no dropout)."""

    def __init__(self, params: dict, cfg: dict, quant=identity, masks=None):
        self.p, self.cfg, self.q, self.masks = params, cfg, quant, masks
        self.dt = getattr(torch, cfg["compute_dtype"])
        self.eps = cfg["layer_norm_epsilon"]

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.q(x).to(self.dt), self.q(self.p[f"{name}.weight"]).to(self.dt))

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.p[f"{name}.weight"] * y).to(self.dt)

    def drop(self, x: torch.Tensor, call: int) -> torch.Tensor:
        if self.masks is None:
            return x
        return x * self.masks(call, x.shape).to(x.dtype)

    def attn(self, pre: str, x, kv, bias, prob_call: int | None) -> torch.Tensor:
        h, dk = self.cfg["num_heads"], self.cfg["d_kv"]
        b, lq, lk = x.shape[0], x.shape[1], kv.shape[1]
        q = self.lin(f"{pre}.q", x).float().reshape(b, lq, h, dk)
        k = self.lin(f"{pre}.k", kv).float().reshape(b, lk, h, dk)
        v = self.lin(f"{pre}.v", kv).float().reshape(b, lk, h, dk)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if bias is not None:
            s = s + bias
        p = torch.softmax(s, dim=-1).to(self.dt)
        if prob_call is not None:
            p = self.drop(p, prob_call)
        o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v).to(self.dt)
        return self.lin(f"{pre}.o", o.reshape(b, lq, h * dk))

    def ff(self, pre: str, x, call: int) -> torch.Tensor:
        z = F.gelu(self.lin(f"{pre}.wi_0", x), approximate="tanh") * self.lin(f"{pre}.wi_1", x)
        return self.lin(f"{pre}.wo", self.drop(z, call))

    def film(self, name: str, x, c) -> torch.Tensor:
        scale, shift = self.lin(name, c)[:, None, :].chunk(2, dim=-1)
        return x * (1 + scale) + shift

    def encoder(self, pre: str, x, bias, call0: int, n_layers: int) -> torch.Tensor:
        x = self.drop(x + position_table(x.shape[1], x.shape[2], x.device), call0)
        for i in range(n_layers):
            c, lp = call0 + 1 + 4 * i, f"{pre}.layers.{i}"
            h = self.norm(f"{lp}.attn_norm", x)
            x = x + self.drop(self.attn(f"{lp}.attn", h, h, bias, c), c + 1)
            x = x + self.drop(self.ff(f"{lp}.ff", self.norm(f"{lp}.ff_norm", x), c + 2), c + 3)
        return self.drop(self.norm(f"{pre}.final_norm", x), call0 + 1 + 4 * n_layers)

    def decoder(self, enc, bias, x_t, t, call0: int) -> torch.Tensor:
        cfg = self.cfg
        tmax = cfg["max_decoder_noise_time"]
        e = noise_embedding(t * tmax, cfg["d_model"], tmax)
        c = F.silu(self.lin("decoder.cond_2", F.silu(self.lin("decoder.cond_1", e))))
        y = self.lin("decoder.input_proj", x_t)
        y = self.drop(y + position_table(y.shape[1], y.shape[2], y.device), call0)
        for i in range(cfg["num_decoder_layers"]):
            k, lp = call0 + 1 + 4 * i, f"decoder.layers.{i}"
            h = self.film(f"{lp}.self_film", self.norm(f"{lp}.self_norm", y), c)
            y = y + self.drop(self.attn(f"{lp}.self_attn", h, h, None, None), k)
            h = self.norm(f"{lp}.cross_norm", y)
            y = y + self.drop(self.attn(f"{lp}.cross_attn", h, enc, bias, None), k + 1)
            h = self.film(f"{lp}.ff_film", self.norm(f"{lp}.ff_norm", y), c)
            y = y + self.drop(self.ff(f"{lp}.ff", h, k + 2), k + 3)
        y = self.drop(self.norm("decoder.final_norm", y), call0 + 1 + 4 * cfg["num_decoder_layers"])
        return self.lin("decoder.spec_out", y).float()


def key_bias(keep: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, 0.0, MASK).float()[:, None, None, :]


def forward(params: dict, cfg: dict, tokens, context, x_t, t, notes_mask=None, masks=None,
            quant=identity) -> torch.Tensor:
    """(B, L) note tokens, (B, Lc, n_mels) context frames, (B, Lt, n_mels)
    noisy frames, (B,) noise times in [0, 1) -> (B, Lt, n_mels) float32
    predicted noise. ``notes_mask`` defaults to ``tokens > 0``."""
    n = Net(params, cfg, quant, masks)
    keep = tokens > 0 if notes_mask is None else notes_mask
    s = 2 + 4 * cfg["num_notes_layers"]
    notes = n.encoder("notes", F.embedding(tokens, params["notes.token_embedder.weight"]),
                      key_bias(keep), 0, cfg["num_notes_layers"])
    ctx = n.encoder("context", n.lin("context.input_proj", context), None, s,
                    cfg["num_context_layers"])
    keep = torch.cat([keep, torch.ones(ctx.shape[:2], dtype=torch.bool, device=keep.device)], 1)
    return n.decoder(torch.cat([notes, ctx], dim=1), key_bias(keep), x_t, t,
                     s + 2 + 4 * cfg["num_context_layers"])


# ---- the step -------------------------------------------------------------------

def batch(tokens, audio, seed: int, cfg: dict) -> dict:
    """One step's batch from its (B, L) tokens, (B, 2, samples) context and
    target audio and its seed: the scaled log-mel context and x0, the noise
    step and eps drawn again from the seed."""
    feats = features(audio, cfg)
    t, eps = noise(seed, tokens.shape[0], cfg, audio.device)
    return {"tokens": tokens, "context": feats[:, 0], "x0": feats[:, 1], "t": t, "eps": eps}


def loss_rows(cfg: dict, seeds: list[int], quant=identity):
    """``steps.train``'s ``loss_rows``: the sum over rows r0..r1 of each
    item's mean squared error of the predicted noise at step ``t``, with
    that step's dropout seed."""
    rate = cfg["dropout_rate"]
    abar = alphas_cumprod(cfg["num_train_timesteps"], "cpu")

    def rows(params, b, r0, r1, t):
        full = b["tokens"].shape[0]
        dev = b["tokens"].device

        def masks(call, shape):
            return mask_rows(seeds[t - 1], call, (full,) + tuple(shape[1:]), rate, r0, r1, dev)

        steps = b["t"][r0:r1]
        a = abar.to(dev)[steps][:, None, None]
        x_t = a.sqrt() * b["x0"][r0:r1] + (1 - a).sqrt() * b["eps"][r0:r1]
        pred = forward(params, cfg, b["tokens"][r0:r1], b["context"][r0:r1], x_t,
                       steps.float() / cfg["num_train_timesteps"], masks=masks, quant=quant)
        return (pred - b["eps"][r0:r1]).pow(2).mean(dim=(1, 2)).sum()

    return rows
