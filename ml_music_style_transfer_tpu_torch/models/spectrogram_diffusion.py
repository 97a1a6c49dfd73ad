"""Spectrogram Diffusion: the third model family (Hawthorne et al., "Multi-
instrument Music Synthesis with Spectrogram Diffusion", ISMIR 2022,
arXiv:2206.05408; the modules of ``google/music-spectrogram-diffusion``).

MIDI note tokens (``midi/events.py``) and the log-mel frames of the segment
before go in; the model predicts the noise in the log-mel frames of the
segment to render. Three stacks of T5 layers, no biases anywhere:

  - notes encoder: ``drop(Embed(tokens) + P[pos])``, pre-norm layers
    ``x += drop(Attn(norm(x), mask))`` (the attention dropping out its
    probabilities after the softmax) and ``x += drop(Wo drop(gelu_tanh(Wi0 h)
    * Wi1 h))`` with ``h = norm(x)``, then ``drop(norm(x))``; the keys'
    padding mask is ``tokens > 0``;
  - context encoder: the same layers over ``drop(Linear(frames) + P[pos])``,
    no mask;
  - FiLM decoder: ``c = SiLU(W2 SiLU(W1 e))`` of the sinusoidal embedding
    ``e`` of the noise time ``2000 t``; each layer is ``y += drop(SelfAttn(
    FiLM(norm(y))))`` (unmasked, no probability dropout), ``y +=
    drop(CrossAttn(norm(y), [notes; context], [mask; 1]))``, ``y +=
    drop(FF(FiLM(norm(y))))`` with ``FiLM(h) = h (1 + scale) + shift`` from
    ``Linear(c)``; input ``drop(Linear(x_t) + P[pos])``, output
    ``Linear(drop(norm(y)))``.

``norm`` is T5's RMSNorm, ``w x rsqrt(mean(x^2) + eps)``, its statistics in
float32. Attention has no ``1/sqrt(d_kv)`` scale; it computes the scores,
adds the mask in float32, takes a float32 softmax, casts to the compute
dtype, drops out through K2 and multiplies by V. ``P`` is a frozen
sinusoidal table (T5X's ``sinusoidal``, a buffer). Numerics as
``ModelConfig``'s: float32 parameters and residual stream, every linear's
input and weight in the compute dtype, norm statistics and softmax in
float32.

Dropout (training, ``dropout_seed`` given) goes through the Philox kernel
K2, each site at a fixed call index: with ``S = 2 + 4 L`` sites in an
encoder of L layers, the notes encoder takes calls 0..S-1 (0 its input,
``1 + 4 l + k`` layer l's attention probabilities, attention output, FF
inner and FF output for k = 0..3, ``S - 1`` its output), the context encoder
the same from S, the decoder from 2 S (its input, then per layer self-
attention output, cross-attention output, FF inner, FF output, then its
output).

``make_spectrogram_diffusion_train_step`` is the family's training step
(DDPM epsilon prediction on the cosine schedule, fused Adam), traced as the
other families' steps with the spans of the three stacks and of each
attention's core, and the counters ``notes_tokens`` and ``notes_positions``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import mel as tmel
from ..ops import stft as tstft
from ..utils import profiling
from .layers import _dtype, fast_dropout

# the notes encoder's positions this process computed, and those that held a
# note token: read by every recorded train step (``profiling.register_counts``)
NOTES_COUNTS = profiling.register_counts({"notes_tokens": 0, "notes_positions": 0})
MASK_BIAS = torch.finfo(torch.float32).min  # added to a masked key's score
NOISE_KEY = 0x9E3779B97F4A7C15  # the noise generator's seed is the step's seed xor this


@dataclasses.dataclass(frozen=True)
class SpectrogramDiffusionConfig:
    """Published widths (``google/music-spectrogram-diffusion``'s diffusers
    config) and the paper's features: 16 kHz, hop 320, 128 mel bands."""
    vocab_size: int = 1536
    max_length: int = 2048           # note tokens a segment
    input_dims: int = 128            # mel bands
    targets_context_length: int = 256
    targets_length: int = 256
    max_decoder_noise_time: float = 2000.0
    d_model: int = 768
    num_heads: int = 12
    d_kv: int = 64
    d_ff: int = 2048
    num_notes_layers: int = 12
    num_context_layers: int = 12
    num_decoder_layers: int = 12
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    compute_dtype: str = "bfloat16"
    sr: int = 16000
    n_fft: int = 2048
    hop: int = 320
    mel_fmin: float = 20.0
    mel_fmax: float = 8000.0
    log_floor: float = 1e-5
    log_max: float = 4.0
    num_train_timesteps: int = 1000


def sinusoidal_table(length: int, d: int) -> torch.Tensor:
    """(length, d) float32: sin in the first half of the features, cos in the
    second, at frequencies ``10000 ** (-i / (d/2 - 1))`` (T5X's fixed
    ``sinusoidal`` with its default scales, 1 to 10000)."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(d // 2) * (-math.log(10000.0) / (d // 2 - 1)))
    table = np.zeros((length, d))
    table[:, : d // 2] = np.sin(pos * div)
    table[:, d // 2: 2 * (d // 2)] = np.cos(pos * div)
    return torch.from_numpy(table.astype(np.float32))


def timestep_embedding(tau: torch.Tensor, d: int, max_period: float) -> torch.Tensor:
    """(B,) noise times -> (B, d) float32 ``[sin(tau f), cos(tau f)]``, ``f_i =
    max_period ** (-i / (d/2 - 1))`` (diffusers' ``get_timestep_embedding``
    with a frequency shift of 1)."""
    half = d // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                            device=tau.device) / (half - 1))
    arg = tau.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


def alphas_cumprod(steps: int) -> torch.Tensor:
    """(steps,) float32 cumulative products of 1 - beta on the cosine
    schedule (``squaredcos_cap_v2``: beta_i = min(1 - abar((i+1)/N) /
    abar(i/N), 0.999), abar(t) = cos((t + 0.008) / 1.008 pi / 2)^2), in
    float64 first."""
    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - abar((i + 1) / steps) / abar(i / steps), 0.999)
                      for i in range(steps)])
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))


def _linear(d_in: int, d_out: int, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device)


class CastWeights(torch.autograd.Function):
    """Every linear's weight in the compute dtype, in one copy a forward:
    the float32 weights (in group order) copied into one flat buffer of
    ``dt``, each group of consecutive weights returned as one (rows, in)
    view; the backward copies the groups' gradients into one flat float32
    buffer and hands each weight its view. The values are those of a cast
    per use and its gradient's cast back."""

    @staticmethod
    def forward(ctx, shapes, dt, *weights):
        sizes = [w.numel() for w in weights]
        flat = torch.empty(sum(sizes), dtype=dt, device=weights[0].device)
        torch._foreach_copy_([v.view_as(w) for v, w in zip(flat.split(sizes), weights)],
                             list(weights))
        ctx.shapes, ctx.sizes, ctx.weight_shapes = shapes, sizes, [w.shape for w in weights]
        return tuple(v.view(r) for v, r in zip(flat.split([a * b for a, b in shapes]), shapes))

    @staticmethod
    def backward(ctx, *grads):
        ref = next(g for g in grads if g is not None)
        flat = torch.empty(sum(ctx.sizes), dtype=torch.float32, device=ref.device)
        views = [v.view(r) for v, r in zip(flat.split([a * b for a, b in ctx.shapes]), ctx.shapes)]
        for v, g in zip(views, grads):
            if g is None:
                v.zero_()
        torch._foreach_copy_([v for v, g in zip(views, grads) if g is not None],
                             [g for g in grads if g is not None])
        return (None, None) + tuple(v.view(r) for v, r in zip(flat.split(ctx.sizes),
                                                               ctx.weight_shapes))


class Weights(dict):
    """One forward's linear weights in the compute dtype ``dt``, each group's
    stacked weight under the group's first layer (``CastWeights``)."""

    def __init__(self, groups: list, dt: torch.dtype):
        weights = [m.weight for g in groups for m in g]
        shapes = [(sum(m.out_features for m in g), g[0].in_features) for g in groups]
        super().__init__(zip((g[0] for g in groups), CastWeights.apply(shapes, dt, *weights)))
        self.dt = dt


def linear(x: torch.Tensor, ws: Weights, layer: nn.Linear) -> torch.Tensor:
    """``x W^T`` for (N, in) ``x`` in the compute dtype, ``W`` the stacked
    weight of the group ``layer`` leads: one product for all its layers."""
    return F.linear(x.to(ws.dt), ws[layer])


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight, self.eps).to(dt)


def attention_core(q, k, v, b: int, bias, dt, drop) -> torch.Tensor:
    """``softmax(q k^T + bias) v`` over (B H, L, d_kv) in ``dt``: scores in
    ``dt``, the (B, 1, 1, Lk) bias added and the softmax taken in float32
    over (B, H, Lq, Lk) (the cast's own tensor takes the bias in place: on a
    view, autograd would copy the whole gradient twice), the probabilities
    cast to ``dt`` and, where ``drop`` is (seed, call, rate), dropped out
    through K2. One span ``sdiff.attention``."""
    with profiling.span("sdiff.attention"):
        s = torch.bmm(q, k.transpose(1, 2))
        s = s.view(b, -1, *s.shape[1:]).float()
        if bias is not None:
            s = s.add_(bias)
        p = torch.softmax(s, dim=-1).to(dt)
        if drop is not None:
            p = fast_dropout(p, *drop)
        return torch.bmm(p.view(-1, *p.shape[2:]), v)


class Attention(nn.Module):
    def __init__(self, cfg: SpectrogramDiffusionConfig, cross: bool = False, device=None):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv, self.cross = cfg.num_heads, cfg.d_kv, cross
        self.q = _linear(cfg.d_model, inner, device)
        self.k = _linear(cfg.d_model, inner, device)
        self.v = _linear(cfg.d_model, inner, device)
        self.o = _linear(inner, cfg.d_model, device)

    def weight_groups(self) -> list[tuple]:
        """Self-attention's q, k and v are one product, cross-attention's k
        and v."""
        if self.cross:
            return [(self.q,), (self.k, self.v), (self.o,)]
        return [(self.q, self.k, self.v), (self.o,)]

    def _heads(self, t: torch.Tensor, b: int, n: int) -> list[torch.Tensor]:
        """(B n, m H d_kv) -> m contiguous (B H, n, d_kv), in one copy."""
        h, dk = self.heads, self.d_kv
        m = t.shape[1] // (h * dk)
        return list(t.view(b, n, m, h, dk).permute(2, 0, 3, 1, 4).contiguous()
                    .view(m, b * h, n, dk).unbind(0))

    def forward(self, x, kv, bias, b: int, ws: Weights, drop=None) -> torch.Tensor:
        """(B Lq, d) queries; ``kv`` (B Lk, d) for cross-attention, None for
        self-attention -> (B Lq, d)."""
        lq = x.shape[0] // b
        if kv is None:
            q, k, v = self._heads(linear(x, ws, self.q), b, lq)
        else:
            (q,) = self._heads(linear(x, ws, self.q), b, lq)
            k, v = self._heads(linear(kv, ws, self.k), b, kv.shape[0] // b)
        o = attention_core(q, k, v, b, bias, ws.dt, drop)
        o = o.view(b, self.heads, lq, self.d_kv).transpose(1, 2).reshape(b * lq, -1)
        return linear(o, ws, self.o)


class GatedFF(nn.Module):
    """``Wo drop(gelu_tanh(Wi0 h) * Wi1 h)``."""

    def __init__(self, cfg: SpectrogramDiffusionConfig, device=None):
        super().__init__()
        self.wi_0 = _linear(cfg.d_model, cfg.d_ff, device)
        self.wi_1 = _linear(cfg.d_model, cfg.d_ff, device)
        self.wo = _linear(cfg.d_ff, cfg.d_model, device)

    def weight_groups(self) -> list[tuple]:
        return [(self.wi_0, self.wi_1), (self.wo,)]

    def forward(self, h, ws: Weights, drop) -> torch.Tensor:
        g, lin = linear(h, ws, self.wi_0).chunk(2, dim=-1)
        z = F.gelu(g, approximate="tanh") * lin
        if drop is not None:
            z = fast_dropout(z, *drop)
        return linear(z, ws, self.wo)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: SpectrogramDiffusionConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, device)
        self.attn = Attention(cfg, device=device)
        self.ff_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, device)
        self.ff = GatedFF(cfg, device)


class Encoder(nn.Module):
    """The notes encoder (``n_in`` None: token embedding) or the context
    encoder (``n_in`` mel bands: a linear input projection)."""

    def __init__(self, cfg: SpectrogramDiffusionConfig, n_layers: int, length: int,
                 n_in: int | None, device=None):
        super().__init__()
        self.rate = cfg.dropout_rate
        if n_in is None:
            self.token_embedder = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        else:
            self.input_proj = _linear(n_in, cfg.d_model, device)
        self.register_buffer("position", sinusoidal_table(length, cfg.d_model).to(device),
                             persistent=False)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device) for _ in range(n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, device)

    def forward(self, inputs, bias, ws: Weights, seed, call0: int) -> torch.Tensor:
        """(B, L) tokens or (B, L, n_in) frames -> (B L, d_model) in the
        compute dtype."""
        dt, (b, n) = ws.dt, inputs.shape[:2]

        def drop(x, call):
            return x if seed is None else fast_dropout(x, seed, call0 + call, self.rate)

        if hasattr(self, "token_embedder"):
            x = self.token_embedder(inputs)
        else:
            x = linear(inputs.reshape(b * n, -1), ws, self.input_proj).view(b, n, -1)
        x = drop((x + self.position[:n]).view(b * n, -1), 0)
        for i, lyr in enumerate(self.layers):
            c = 1 + 4 * i
            a = lyr.attn(lyr.attn_norm(x, dt), None, bias, b, ws,
                         None if seed is None else (seed, call0 + c, self.rate))
            x = x + drop(a, c + 1)
            f = lyr.ff(lyr.ff_norm(x, dt), ws,
                       None if seed is None else (seed, call0 + c + 2, self.rate))
            x = x + drop(f, c + 3)
        return drop(self.final_norm(x, dt), 1 + 4 * len(self.layers))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: SpectrogramDiffusionConfig, device=None):
        super().__init__()
        d, cond = cfg.d_model, 4 * cfg.d_model
        self.self_norm = RMSNorm(d, cfg.layer_norm_epsilon, device)
        self.self_film = _linear(cond, 2 * d, device)
        self.self_attn = Attention(cfg, device=device)
        self.cross_norm = RMSNorm(d, cfg.layer_norm_epsilon, device)
        self.cross_attn = Attention(cfg, cross=True, device=device)
        self.ff_norm = RMSNorm(d, cfg.layer_norm_epsilon, device)
        self.ff_film = _linear(cond, 2 * d, device)
        self.ff = GatedFF(cfg, device)


def film(h: torch.Tensor, c: torch.Tensor, layer: nn.Linear, ws: Weights) -> torch.Tensor:
    """``h (1 + scale) + shift`` over (B L, d) ``h``, (scale, shift) the
    halves of ``Linear(c)`` of each of the B items."""
    b = c.shape[0]
    scale, shift = linear(c, ws, layer)[:, None, :].chunk(2, dim=-1)
    return (h.view(b, -1, h.shape[-1]) * (1 + scale) + shift).view(h.shape)


class FilmDecoder(nn.Module):
    def __init__(self, cfg: SpectrogramDiffusionConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.rate = cfg.dropout_rate
        self.max_noise_time = cfg.max_decoder_noise_time
        self.cond_1 = _linear(d, 4 * d, device)
        self.cond_2 = _linear(4 * d, 4 * d, device)
        self.input_proj = _linear(cfg.input_dims, d, device)
        self.register_buffer("position", sinusoidal_table(cfg.targets_length, d).to(device),
                             persistent=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.num_decoder_layers))
        self.final_norm = RMSNorm(d, cfg.layer_norm_epsilon, device)
        self.spec_out = _linear(d, cfg.input_dims, device)

    def forward(self, enc, bias, x_t, t, ws: Weights, seed, call0: int) -> torch.Tensor:
        """(B Lk, d) encodings, their (B, 1, 1, Lk) bias, (B, L, input_dims)
        noisy frames, (B,) noise times in [0, 1) -> (B, L, input_dims)
        float32 predicted noise."""
        dt, (b, n) = ws.dt, x_t.shape[:2]

        def drop(x, call):
            return x if seed is None else fast_dropout(x, seed, call0 + call, self.rate)

        e = timestep_embedding(t * self.max_noise_time, self.cond_1.in_features,
                               self.max_noise_time)
        c = F.silu(linear(F.silu(linear(e, ws, self.cond_1)), ws, self.cond_2))
        y = linear(x_t.reshape(b * n, -1), ws, self.input_proj).view(b, n, -1)
        y = drop((y + self.position[:n]).view(b * n, -1), 0)
        for i, lyr in enumerate(self.layers):
            k = 1 + 4 * i
            h = film(lyr.self_norm(y, dt), c, lyr.self_film, ws)
            y = y + drop(lyr.self_attn(h, None, None, b, ws), k)
            y = y + drop(lyr.cross_attn(lyr.cross_norm(y, dt), enc, bias, b, ws), k + 1)
            h = film(lyr.ff_norm(y, dt), c, lyr.ff_film, ws)
            y = y + drop(lyr.ff(h, ws, None if seed is None else (seed, call0 + k + 2,
                                                                   self.rate)), k + 3)
        y = drop(self.final_norm(y, dt), 1 + 4 * len(self.layers))
        return linear(y, ws, self.spec_out).float().view(b, n, -1)


def weight_groups(model: nn.Module) -> list[tuple]:
    """The linears of ``model`` in groups whose stacked weight is one
    product: those a module declares (``weight_groups``), every other alone."""
    groups = [g for m in model.modules() if hasattr(m, "weight_groups") for g in m.weight_groups()]
    seen = {m for g in groups for m in g}
    return groups + [(m,) for m in model.modules() if isinstance(m, nn.Linear) and m not in seen]


def key_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) bool keep-mask of keys -> (B, 1, 1, L) float32 additive bias."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, MASK_BIAS)[:, None, None, :]


class SpectrogramDiffusion(nn.Module):
    """Notes encoder, context encoder and FiLM decoder. Weights by T5's
    initialisation from a generator seeded 0 on the device:
    norms 1, the embedding N(0, 1), q N(0, (d_model d_kv)^-1), k and v
    N(0, 1/d_model), o N(0, 1/(heads d_kv)), wi N(0, 1/d_model), wo
    N(0, 1/d_ff), every other linear xavier-normal.

    Inside, activations are (B L, d) rows, every linear's weight is cast to
    the compute dtype in one copy a forward (``CastWeights``), the
    projections of one input (q, k and v; k and v; wi_0 and wi_1) are one
    product over their stacked weights, and attention runs as batched
    products over (B H, L, d_kv): a third fewer host calls a step, without
    which the host's launches, not the card, paced a full-width step at
    batch 8 on an H100."""

    def __init__(self, cfg: SpectrogramDiffusionConfig = SpectrogramDiffusionConfig(),
                 device=None):
        super().__init__()
        with profiling.setup_span("setup.model"):
            self.cfg = cfg
            self.notes = Encoder(cfg, cfg.num_notes_layers, cfg.max_length, None, device)
            self.context = Encoder(cfg, cfg.num_context_layers, cfg.targets_context_length,
                                   cfg.input_dims, device)
            self.decoder = FilmDecoder(cfg, device)
            self.dt = _dtype(cfg.compute_dtype)
            self.groups = weight_groups(self)
            first = next(self.parameters())
            if first.device.type == "meta":
                return
            gen = torch.Generator(device=first.device).manual_seed(0)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    std = init_std(name, cfg)
                    if std is None:
                        p.fill_(1.0)
                    elif std == "xavier":
                        nn.init.xavier_normal_(p, generator=gen)
                    else:
                        p.normal_(0.0, std, generator=gen)

    def forward(self, tokens: torch.Tensor, context: torch.Tensor, x_t: torch.Tensor,
                t: torch.Tensor, notes_mask: torch.Tensor | None = None,
                dropout_seed: int | None = None) -> torch.Tensor:
        """(B, L) note tokens, (B, Lc, input_dims) context frames, (B, Lt,
        input_dims) noisy target frames, (B,) noise times in [0, 1) ->
        (B, Lt, input_dims) float32 predicted noise. ``notes_mask`` (B, L)
        bool defaults to ``tokens > 0``; ``dropout_seed`` (64-bit) turns
        dropout on."""
        c = self.cfg
        b = tokens.shape[0]
        mask = tokens > 0 if notes_mask is None else notes_mask
        ctx_calls = 2 + 4 * c.num_notes_layers
        ws = Weights(self.groups, self.dt)
        with profiling.span("sdiff.notes_encoder"):
            notes = self.notes(tokens, key_bias(mask), ws, dropout_seed, 0)
        with profiling.span("sdiff.context_encoder"):
            ctx = self.context(context, None, ws, dropout_seed, ctx_calls)
        with profiling.span("sdiff.decoder"):
            keep = torch.cat([mask, torch.ones(context.shape[:2], dtype=torch.bool,
                                               device=mask.device)], dim=1)
            enc = torch.cat([notes.view(b, -1, c.d_model), ctx.view(b, -1, c.d_model)], dim=1)
            return self.decoder(enc.view(-1, c.d_model), key_bias(keep), x_t, t, ws,
                                dropout_seed, ctx_calls + 2 + 4 * c.num_context_layers)


def init_std(name: str, cfg: SpectrogramDiffusionConfig):
    """T5's initial standard deviation of parameter ``name``: None for a norm
    weight (ones), "xavier" for the linears T5 does not have."""
    leaf = name.split(".")[-2]
    if leaf.endswith("norm"):
        return None
    return {"token_embedder": 1.0, "q": (cfg.d_model * cfg.d_kv) ** -0.5,
            "k": cfg.d_model ** -0.5, "v": cfg.d_model ** -0.5,
            "o": (cfg.num_heads * cfg.d_kv) ** -0.5, "wi_0": cfg.d_model ** -0.5,
            "wi_1": cfg.d_model ** -0.5, "wo": cfg.d_ff ** -0.5}.get(leaf, "xavier")


class SpectrogramDiffusionTrainer(NamedTuple):
    """Handles from ``make_spectrogram_diffusion_train_step``."""
    step: Callable        # (tokens, audio, seed) -> loss (device scalar)
    optimizer: torch.optim.Adam


def make_spectrogram_diffusion_train_step(model: SpectrogramDiffusion,
                                          learning_rate: float = 1e-3
                                          ) -> SpectrogramDiffusionTrainer:
    """DDPM epsilon prediction for ``model``, which it updates in place with
    Adam (fused on the card).

    ``step(tokens, audio, seed)``: ``tokens`` (B, max_length) int note
    tokens on the host (counted there, then uploaded), ``audio`` (B, 2,
    samples) float rows on the device, each the context segment then the
    target segment, ``seed`` the step's 64-bit seed. Under ``train.input``
    the log-mel of both segments (``ops/mel.log_mel_frames``), clipped to
    ``[log(log_floor), log_max]`` and scaled to [-1, 1], becomes the context
    and ``x0``; the noise step ``t`` uniform over the schedule's steps and
    ``eps`` standard normal are drawn on the device, in that order, from a
    generator seeded with ``seed ^ NOISE_KEY``, and ``x_t = sqrt(abar_t) x0 +
    sqrt(1 - abar_t) eps``. The forward (dropout seed ``seed``, noise time
    ``t / steps``) runs under ``train.forward`` and the MSE of the predicted
    noise under ``train.loss``; backward and Adam under ``train.backward``
    and ``train.optimizer``, all inside ``train.step``. The step counts the
    batch's note tokens and positions in ``NOTES_COUNTS``."""
    cfg = model.cfg
    params = list(model.parameters())
    dev = params[0].device
    lo, hi = math.log(cfg.log_floor), cfg.log_max
    abar = alphas_cumprod(cfg.num_train_timesteps).to(dev)
    gen = torch.Generator(device=dev)
    with profiling.setup_span("setup.model"):
        optimizer = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                     fused=True if dev.type == "cuda" else None)

    @torch.no_grad()
    def features(audio: torch.Tensor):
        m = tmel.log_mel_frames(audio, cfg.sr, cfg.n_fft, cfg.hop, cfg.input_dims,
                                cfg.mel_fmin, cfg.mel_fmax, cfg.log_floor)
        m = (m.clamp(lo, hi) - lo) * (2.0 / (hi - lo)) - 1.0
        return m[:, 0], m[:, 1]

    def noise(seed: int, batch: int):
        gen.manual_seed(int(seed) ^ NOISE_KEY)
        t = torch.randint(0, cfg.num_train_timesteps, (batch,), generator=gen, device=dev)
        eps = torch.randn((batch, cfg.targets_length, cfg.input_dims), generator=gen, device=dev)
        return t, eps

    def step(tokens: torch.Tensor, audio: torch.Tensor, seed: int) -> torch.Tensor:
        with profiling.span("train.step", step=True):
            optimizer.zero_grad(set_to_none=True)
            with profiling.span("train.input"):
                NOTES_COUNTS["notes_tokens"] += int(torch.count_nonzero(tokens))
                NOTES_COUNTS["notes_positions"] += tokens.numel()
                tok = tstft.to_device(tokens, dev)
                context, x0 = features(audio)
                t, eps = noise(seed, tokens.shape[0])
                a = abar[t][:, None, None]
                x_t = a.sqrt() * x0 + (1 - a).sqrt() * eps
            with profiling.span("train.forward"):
                pred = model(tok, context, x_t, t.float() / cfg.num_train_timesteps,
                             dropout_seed=seed)
            with profiling.span("train.loss"):
                loss = F.mse_loss(pred, eps)
            with profiling.span("train.backward"):
                loss.backward()
            with profiling.span("train.optimizer"):
                optimizer.step()
            return loss.detach()

    return SpectrogramDiffusionTrainer(step=step, optimizer=optimizer)

