"""PerformanceNet: dual-encoder conditioned U-Net, in PyTorch.

Counterpart of the JAX package's ``models/performance_net.py`` (reference
model/model.py:111-300), with the same plan:
  - MIDI encoder: 5 DownConvs 128 -> 256..4096, pooling on the first 4
    (T 860 -> 430 -> 215 -> 107 -> 53); audio encoder: 1025 -> 1536..6144
  - 5 DenseConcat fusions (in = midi + audio, hidden = 1.5*midi, out = midi)
  - onset/offset encoder: 3 pooling DownConvs; its last two pooled maps
    condition the first two UpConvs, deepest first (the reference's
    ``Onoff_Conditions[i-1]`` quirk)
  - 4 UpConvs with kernels 6, 4, 3, 2 (T 53 -> 108 -> 216 -> 431 -> 860)
  - 4 MBRBlocks with 2/4/8/16 bands; head ConvTranspose1d(k3, s1, p1) + LReLU

Attribute names give the reference ``state_dict`` keys (down_convs.i.conv1,
dense_concats.i.fc1, up_convs.i.upconv, MBRBlockj.conv_list1.b, lastconv,
onset_offset_encoder.down_convs.i.conv1, ...), so a reference checkpoint
loads with ``load_state_dict(strict=True)``.

Public I/O is the JAX layout: midi (B, T, 128), conditioning spec
(B, T, 1025), onoff (B, T, 128) -> (B, T, 1025) float32 (float64 with a
float64 compute dtype). Inside, the shapes are channel-first (B, C, T). In
a training forward on the card the memory is channel-last: ``forward``
casts each input to the compute dtype as a contiguous (B, T, C) tensor
(one pass, the cast the first convolution makes anyway;
``layers.model_input``) and views it as (B, C, T), so every convolution
hands cuDNN the NHWC layout its bf16 engines run in, and no transpose runs
around a convolution or its gradients (``models/layers.py``); the head's
output returns channel-first, the layout the loss's target (the STFT's
(B, 1025, T)) is stored in, and leaves as its (B, T, 1025) view. On the
CPU and in inference the inputs enter channel-first contiguous.
``forward_channel_first`` takes the layout it is given.

Training mode (``deterministic=False``) takes a 64-bit ``dropout_seed``:
DenseConcat i draws its two masks with call indices 2i and 2i + 1, so one
seed gives the step's ten masks. ``cfg.remat`` recomputes each encoder
DownConv in the backward pass, as the JAX model's ``nn.remat(DownConv)``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from .layers import (ConvTranspose1dTorch, DenseConcat, DownConv, MBRBlock, UpConv, _Affine,
                     _dtype, channel_last, leaky_relu, model_input, stat_dtype,
                     to_channel_first, to_channel_last)


class OnsetOffsetEncoder(nn.Module):
    """3-level onset/offset condition encoder (reference model.py:111-141)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.depth = cfg.onset_encoder_depth
        downs, ins = [], cfg.start_channels
        for i in range(cfg.onset_encoder_depth):
            outs = cfg.scaled(cfg.start_channels * (2 ** (i + 1)))
            downs.append(DownConv(ins, outs, True, cfg.compute_dtype,
                                  cfg.leaky_relu_slope, cfg.instance_norm_eps, device))
            ins = outs
        self.down_convs = nn.ModuleList(downs)

    def forward(self, x):
        conditions = []
        for i, down in enumerate(self.down_convs):
            x, _ = down(x)
            if i > self.depth - 3:  # the last two pooled maps (model.py:139-140)
                conditions.append(x)
        return conditions


class PerformanceNet(nn.Module):
    """Full dual-encoder conditioned U-Net (reference model.py:177-300).

    Weights are xavier-normal and biases zero, drawn from ``generator``
    (default: seeded 0 on the parameters' device). On the ``meta`` device
    nothing is drawn: use it to count parameters or as the target of
    ``load_state_dict(..., assign=True)``.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        midi_plan, audio_plan = cfg.midi_channel_plan, cfg.audio_channel_plan
        dt, slope, eps = cfg.compute_dtype, cfg.leaky_relu_slope, cfg.instance_norm_eps

        def downs(in_ch, plan):
            mods = []
            for i, outs in enumerate(plan):
                mods.append(DownConv(in_ch, outs, i < cfg.depth - 1, dt, slope, eps, device))
                in_ch = outs
            return nn.ModuleList(mods)

        self.down_convs = downs(cfg.start_channels, midi_plan)
        self.down_convs_audio = downs(cfg.start_audio_channels, audio_plan)
        self.dense_concats = nn.ModuleList([
            DenseConcat(midi_plan[-(i + 1)] + audio_plan[-(i + 1)],
                        int(midi_plan[-(i + 1)] * 1.5), midi_plan[-(i + 1)],
                        cfg.dropout_rate, dt, device)
            for i in range(cfg.depth)])
        onoff_ch = [cfg.scaled(cfg.start_channels * 2 ** (i + 1))
                    for i in range(cfg.onset_encoder_depth)]
        # (in, out, skip = that level's DenseConcat out, cond, kernel),
        # model.py:228-233; conditions deepest first ([i-1] quirk)
        up_specs = [
            (midi_plan[4], midi_plan[3], midi_plan[3], onoff_ch[-1], 6),
            (midi_plan[3], midi_plan[2], midi_plan[2], onoff_ch[-2], 4),
            (midi_plan[2], midi_plan[2], midi_plan[1], 0, 3),
            (midi_plan[2], midi_plan[2], midi_plan[0], 0, 2),
        ]
        self.up_convs = nn.ModuleList([
            UpConv(i, o, s, c, k, dt, slope, eps, device) for i, o, s, c, k in up_specs])
        for j, bands in enumerate((2, 4, 8, 16), start=1):
            setattr(self, f"MBRBlock{j}", MBRBlock(midi_plan[2], bands, cfg.compat_mbr_noop,
                                                   dt, slope, eps, device))
        self.lastconv = ConvTranspose1dTorch(midi_plan[2], cfg.n_out_bins, 3, 1, 1, dt, device)
        self.onset_offset_encoder = OnsetOffsetEncoder(cfg, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Xavier-normal weights, zero biases, in ``named_parameters`` order."""
        first = next(self.parameters())
        if first.device.type == "meta":
            return
        if generator is None:
            generator = torch.Generator(device=first.device).manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            else:
                nn.init.xavier_normal_(p, generator=generator)

    def shard_tensor_parallel_(self, group) -> "PerformanceNet":
        """Tensor parallelism over the model-axis ``group``: each
        conv, transposed conv and DenseConcat linear keeps this rank's
        slice along the dim ``parallel/mesh.tp_dims`` gives it (dims the
        axis does not divide stay whole). The forward then gives every
        model rank the unsharded model's output; ``load_state_dict`` takes
        an unsharded state_dict and ``full_state_dict`` returns one."""
        from ..parallel import comm, mesh as pmesh

        dims = pmesh.tp_dims({k: tuple(p.shape) for k, p in self.named_parameters()},
                             comm.group_size(group))
        for name, mod in self.named_modules():
            if isinstance(mod, _Affine) and f"{name}.weight" in dims:
                mod.shard_(group, dims[f"{name}.weight"], f"{name}.bias" in dims)
        return self

    def tp_dims(self) -> dict[str, int]:
        """{state_dict key: sharded dim} of the tensor-parallel parameters."""
        return {f"{name}.{p}": d for name, mod in self.named_modules()
                if isinstance(mod, _Affine) for p, d in mod.tp_dims().items()}

    def tp_group(self):
        """The model-axis group of a tensor-parallel model, else None."""
        return next((m.tp_group for m in self.modules()
                     if isinstance(m, _Affine) and m.tp_group is not None), None)

    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The unsharded state_dict: tensor-parallel slices gathered over
        the model axis (a collective: every model rank calls it)."""
        from ..parallel import comm

        dims, group = self.tp_dims(), self.tp_group()
        return {k: comm.all_gather_cat(v, group, dims[k]) if k in dims else v
                for k, v in self.state_dict().items()}

    def _encode(self, down: DownConv, x):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(down, x, use_reentrant=False)
        return down(x)

    def forward_channel_first(self, midi, audio, cond, deterministic: bool = True,
                              dropout_seed: int | None = None):
        """(B,128,T), (B,1025,T), (B,128,T) -> (B,1025,T') float32: the
        reference's model(score, spec, onoff) layout (model.py:262)."""
        midi_skips, audio_skips = [], []
        h = midi
        for down in self.down_convs:
            h, before = self._encode(down, h)
            midi_skips.append(before)
        a = audio
        for down in self.down_convs_audio:
            a, before = self._encode(down, a)
            audio_skips.append(before)

        x = self.dense_concats[0](h, a, deterministic, dropout_seed, 0)
        if channel_last(h):  # the decoder runs in the encoders' layout
            x = to_channel_last(x)
        onoff_conditions = self.onset_offset_encoder(cond)
        for i, up in enumerate(self.up_convs):
            skip = self.dense_concats[i + 1](midi_skips[-(i + 2)], audio_skips[-(i + 2)],
                                             deterministic, dropout_seed, 2 * (i + 1))
            # reference indexing quirk: Onoff_Conditions[i-1] => [-1] then [0]
            c = onoff_conditions[i - 1] if up.has_condition else None
            x = up(skip, x, c)
        for j in range(1, 5):
            x = getattr(self, f"MBRBlock{j}")(x)
        # leaves channel-first, as the loss's target is stored
        x = to_channel_first(self.lastconv.full(self.lastconv(x)))
        x = leaky_relu(x, self.cfg.leaky_relu_slope)
        return x.to(stat_dtype(x.dtype))

    def forward(self, x_midi, x_audio, cond, deterministic: bool = True,
                dropout_seed: int | None = None):
        """midi (B,T,128), audio spec (B,T,1025), onoff (B,T,128) ->
        (B,T',1025) float32, the JAX model's channel-last signature; a
        training forward runs channel-last inside on the card (the module
        docstring)."""
        dt = _dtype(self.cfg.compute_dtype)
        out = self.forward_channel_first(*(model_input(x, dt) for x in (x_midi, x_audio, cond)),
                                         deterministic, dropout_seed)
        return out.transpose(1, 2)


def forward_channel_first(model: PerformanceNet, midi_cf, spec_cf, onoff_cf, **kw):
    """Reference-layout adapter: (B,128,860)/(B,1025,860)/(B,128,860) in,
    (B,1025,860) out (model/inference.py:84)."""
    return model.forward_channel_first(midi_cf, spec_cf, onoff_cf, **kw)


def temporal_ladder(t_in: int = 860, depth: int = 5) -> dict:
    """Pure shape math for tests: the encoder/decoder time ladder."""
    enc = [t_in]
    t = t_in
    for _ in range(depth - 1):
        t = t // 2
        enc.append(t)
    dec = [t]
    for k in (6, 4, 3, 2):
        t = (t - 1) * 2 - 2 + k
        dec.append(t)
    return {"encoder": enc, "decoder": dec}
