"""PerformanceNet and the spectrogram autoencoder as plain functions of a
parameter dict, in the precision the configuration states.

The architecture is silburt/ML_Music_Style_Transfer ``model/model.py``
(dual-encoder U-Net, DenseConcat fusions, onset/offset conditions, four
multi-band residual blocks, a transposed-conv head), with the intended MBR
residual (``compat_mbr_noop`` false). Parameter names and layouts are the
reference repository's ``state_dict`` (Conv1d (out, in, k), ConvTranspose1d
(in, out, k), Linear (out, in)). Activations are channel-first (B, C, T).

Numerics follow the configuration's ``compute_dtype`` (bfloat16): every
convolution and linear takes its input, weight and bias in it and returns
it, elementwise steps run in it, InstanceNorm takes float32 statistics and
returns to it, parameters are float32, and the head's output is float32.
(A float32 reference is no yardstick here: with random weights the network
amplifies rounding about fiftyfold, so the bfloat16 program sits as far
from it as a float8 one does; see PERF.md.) ``quant`` is applied to the
inputs and weights of every convolution and linear first: the identity for
the reference, ``fp8`` for the control, the next precision below.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8_e4m3fn with one per-tensor scale (amax
    to 448); the gradient passes straight through."""
    x32 = x.detach().float()
    scale = x32.abs().amax().clamp(min=1e-30) / FP8_MAX
    q = ((x32 / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()


# ---- shapes ----------------------------------------------------------------

def _conv(shapes, name, c_in, c_out, k=3):
    shapes[f"{name}.weight"] = (c_out, c_in, k)
    shapes[f"{name}.bias"] = (c_out,)


def _convt(shapes, name, c_in, c_out, k):
    shapes[f"{name}.weight"] = (c_in, c_out, k)
    shapes[f"{name}.bias"] = (c_out,)


def _down(shapes, name, c_in, c_out):
    _conv(shapes, f"{name}.conv1", c_in, c_out)
    _conv(shapes, f"{name}.conv2", c_out, c_out)


def up_specs(cfg: dict) -> list[tuple[int, int, int, int, int]]:
    """(in, out, skip, cond, kernel) of the four UpConvs (model.py:228-233)."""
    m, onset = cfg["midi_channel_plan"], cfg["midi_channel_plan"][:cfg["onset_encoder_depth"]]
    k = cfg["upconv_kernels"]
    return [(m[4], m[3], m[3], onset[-1], k[0]), (m[3], m[2], m[2], onset[-2], k[1]),
            (m[2], m[2], m[1], 0, k[2]), (m[2], m[2], m[0], 0, k[3])]


def performancenet_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """{parameter name: shape} of PerformanceNet under ``cfg``."""
    s: dict[str, tuple[int, ...]] = {}
    midi, audio = cfg["midi_channel_plan"], cfg["audio_channel_plan"]
    for prefix, c_in, plan in (("down_convs", cfg["start_channels"], midi),
                               ("down_convs_audio", cfg["start_audio_channels"], audio)):
        for i, c_out in enumerate(plan):
            _down(s, f"{prefix}.{i}", c_in, c_out)
            c_in = c_out
    for i in range(len(midi)):
        c_m, c_a = midi[-(i + 1)], audio[-(i + 1)]
        inter = int(c_m * 1.5)
        s[f"dense_concats.{i}.fc1.weight"] = (inter, c_m + c_a)
        s[f"dense_concats.{i}.fc1.bias"] = (inter,)
        s[f"dense_concats.{i}.fc2.weight"] = (c_m, inter)
        s[f"dense_concats.{i}.fc2.bias"] = (c_m,)
    for i, (c_in, c_out, skip, cond, k) in enumerate(up_specs(cfg)):
        _convt(s, f"up_convs.{i}.upconv", c_in, c_out, k)
        _conv(s, f"up_convs.{i}.conv1", c_out + skip, c_out)
        _conv(s, f"up_convs.{i}.conv2", c_out + cond, c_out)
    if not cfg["compat_mbr_noop"]:
        for j, bands in enumerate(cfg["mbr_bands"], start=1):
            band = midi[2] // bands
            for b in range(bands):
                _conv(s, f"MBRBlock{j}.conv_list1.{b}", band, band)
                _conv(s, f"MBRBlock{j}.conv_list2.{b}", band, band)
    _convt(s, "lastconv", midi[2], cfg["start_audio_channels"], 3)
    c_in = cfg["start_channels"]
    for i in range(cfg["onset_encoder_depth"]):
        _down(s, f"onset_offset_encoder.down_convs.{i}", c_in, midi[i])
        c_in = midi[i]
    return s


def autoencoder_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """{parameter name: shape} of the spectrogram autoencoder under ``cfg``."""
    s: dict[str, tuple[int, ...]] = {}
    w, n = cfg["width"], cfg["n_bins"]
    _down(s, "down_0", n, w)
    _down(s, "down_1", w, 2 * w)
    _down(s, "bottleneck", 2 * w, 4 * w)
    _convt(s, "up_0", 4 * w, 2 * w, 4)
    _convt(s, "up_1", 2 * w, w, 4)
    _conv(s, "head", w, n)
    return s


# ---- layers ----------------------------------------------------------------

class Net:
    """The layer arithmetic over ``params`` with ``quant`` on every
    convolution's and linear's inputs and weights."""

    def __init__(self, params: dict, cfg: dict, quant=identity):
        self.p, self.cfg, self.q = params, cfg, quant
        self.dt = getattr(torch, cfg["compute_dtype"])
        self.slope = cfg.get("leaky_relu_slope", 0.01)
        self.eps = cfg.get("instance_norm_eps", 1e-5)

    def _wb(self, name):
        return (self.q(self.p[f"{name}.weight"]).to(self.dt),
                self.p[f"{name}.bias"].to(self.dt))

    def conv(self, name, x):
        w, b = self._wb(name)
        return F.conv1d(self.q(x).to(self.dt), w, b, padding=1)

    def convt(self, name, x, stride, padding):
        w, b = self._wb(name)
        return F.conv_transpose1d(self.q(x).to(self.dt), w, b, stride=stride, padding=padding)

    def linear(self, name, x):
        w, b = self._wb(name)
        return torch.matmul(w, self.q(x).to(self.dt)) + b[:, None]

    def norm(self, x):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
        return ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)

    def act(self, x):
        return F.leaky_relu(x, self.slope)

    def block(self, name, x):
        return self.act(self.norm(self.conv(name, x)))

    def down(self, name, x, pool):
        x = self.block(f"{name}.conv2", self.block(f"{name}.conv1", x))
        return (F.max_pool1d(x, 2, 2) if pool else x), x


def crop_and_concat(up: torch.Tensor, bypass: torch.Tensor) -> torch.Tensor:
    """Centre-crop or pad ``bypass`` to ``up``'s length (model.py:71-78), then
    concatenate on channels."""
    t_up, t_by = up.shape[-1], bypass.shape[-1]
    c = (t_by - t_up) // 2
    if c > 0:
        bypass = bypass[..., c:t_by - c]
    elif c < 0:
        bypass = F.pad(bypass, (-c, -c))
    if bypass.shape[-1] > t_up:
        bypass = bypass[..., :t_up]
    elif bypass.shape[-1] < t_up:
        bypass = F.pad(bypass, (0, t_up - bypass.shape[-1]))
    return torch.cat([up, bypass], dim=1)


def performancenet(params: dict, cfg: dict, midi, spec, onoff, masks=None, quant=identity):
    """(B, T, 128) piano roll, (B, T, 1025) conditioning log-power spec,
    (B, T, 128) onsets -> (B, T, 1025) float32. ``masks``: None (eval) or a function
    ``(call_index, shape) -> scaled keep-mask`` for DenseConcat's dropouts,
    fc1 of fusion i taking call 2i and fc2 call 2i + 1."""
    n = Net(params, cfg, quant)
    depth = len(cfg["midi_channel_plan"])
    h, a, c = midi.transpose(1, 2), spec.transpose(1, 2), onoff.transpose(1, 2)
    midi_skips, audio_skips = [], []
    for i in range(depth):
        h, before = n.down(f"down_convs.{i}", h, i < depth - 1)
        midi_skips.append(before)
    for i in range(depth):
        a, before = n.down(f"down_convs_audio.{i}", a, i < depth - 1)
        audio_skips.append(before)

    def dense(i, m, au, call):
        x = torch.cat([au.to(n.dt), m.to(n.dt)], dim=1)
        x = F.relu(n.linear(f"dense_concats.{i}.fc1", x))
        if masks is not None:
            x = x * masks(call, x.shape).to(n.dt)
        x = F.relu(n.linear(f"dense_concats.{i}.fc2", x))
        if masks is not None:
            x = x * masks(call + 1, x.shape).to(n.dt)
        return x

    x = dense(0, h, a, 0)
    conditions = []
    for i in range(cfg["onset_encoder_depth"]):
        c, _ = n.down(f"onset_offset_encoder.down_convs.{i}", c, True)
        if i > cfg["onset_encoder_depth"] - 3:
            conditions.append(c)
    for i, (_, _, _, cond_ch, k) in enumerate(up_specs(cfg)):
        skip = dense(i + 1, midi_skips[-(i + 2)], audio_skips[-(i + 2)], 2 * (i + 1))
        pre = f"up_convs.{i}"
        y = n.act(n.norm(n.convt(f"{pre}.upconv", x, 2, 1)))
        y = n.block(f"{pre}.conv1", crop_and_concat(y, skip))
        if cond_ch > 0:  # the reference's Onoff_Conditions[i - 1]
            y = crop_and_concat(y, conditions[i - 1])
        x = n.block(f"{pre}.conv2", y)
    for j, bands in enumerate(cfg["mbr_bands"], start=1):
        if cfg["compat_mbr_noop"]:
            x = 2.0 * x
            continue
        outs = []
        for b, band in enumerate(torch.chunk(x, bands, dim=1)):
            t = n.block(f"MBRBlock{j}.conv_list1.{b}", band)
            outs.append(n.norm(n.conv(f"MBRBlock{j}.conv_list2.{b}", t)))
        x = x + torch.cat(outs, dim=1)
    x = n.act(n.convt("lastconv", x, 1, 1))
    return x.float().transpose(1, 2)


def autoencoder(params: dict, cfg: dict, x, quant=identity):
    """(B, T, n_bins) -> (B, T, n_bins): three DownConvs (pooling on the
    first two), two 2x transposed-conv upsamples with InstanceNorm and
    LeakyReLU, a conv head with ReLU."""
    n = Net(params, cfg, quant)
    h = x.transpose(1, 2)
    h, _ = n.down("down_0", h, True)
    h, _ = n.down("down_1", h, True)
    h, _ = n.down("bottleneck", h, False)
    h = n.act(n.norm(n.convt("up_0", h, 2, 1)))
    h = n.act(n.norm(n.convt("up_1", h, 2, 1)))
    return F.relu(n.conv("head", h)).float().transpose(1, 2)
