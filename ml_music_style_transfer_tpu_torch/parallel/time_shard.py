"""Time-axis (sequence) parallelism for the fully-convolutional model: the
port of the JAX package's ``parallel/time_shard.py``.

Each rank of a mesh axis holds an equal contiguous time slice of a clip,
channel-first (B, C, T_loc), and the cross-rank data motion is explicit
(``parallel/comm.py``):
  - ``halo_exchange``: h-frame halos from the neighbours (zeros at the
    clip's edges = the conv's zero padding), differentiable;
  - ``sharded_instance_norm`` / ``masked_instance_norm``: InstanceNorm
    over the GLOBAL time axis from per-rank sums summed over the axis (the
    masked one over a valid prefix of a zero-padded clip, two-pass, with
    the padding exactly zero);
  - the shift ops (``crop_and_concat``'s centre crop as a global shift) and
    the transposed convs (stride 2 from a 2-frame halo, the head's stride
    1 from a 1-frame one);
  - every PerformanceNet block (``sharded_down_conv``, ``sharded_up_conv``,
    ``sharded_dense_concat``, ``sharded_mbr_block``) on the model's own
    modules, and the whole forward (``make_time_sharded_forward``) on a
    zero-padded clip (``padded_length``) whose intermediates track their
    valid lengths as static shape math, so padding never reaches the
    statistics;
  - ``make_time_sharded_train_step`` / ``TimeShardedTrainer``: L1 + Adam
    through that forward. Each rank back-propagates its share of the loss;
    the halo exchanges send gradients back the way the values came, the
    statistics' sums sum their gradients too, and the parameters'
    gradients are summed over the axis (what JAX's ``shard_map`` autodiff
    does implicitly), so a step is one device's step on the unpadded clip.

On one device the plain ``PerformanceNet`` on the unpadded clip is the
whole-clip forward (``whole_clip_forward``): the JAX package's tests hold
the time-sharded forward equal to it (tests/test_inference.py:376-401).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import PerformanceNet
from ..models.layers import leaky_relu, stat_dtype
from . import comm
from . import mesh as pmesh


def time_sharded_output_length(t_valid: int, depth: int = 5) -> int:
    """The net's output frame count for a ``t_valid``-frame input (shape
    math of ``models/performance_net.temporal_ladder``)."""
    t = t_valid
    for _ in range(depth - 1):
        t //= 2
    for k in (6, 4, 3, 2):
        t = 2 * t + k - 4
    return t


def padded_length(t_valid: int, n_shards: int, depth: int = 5) -> int:
    """Smallest padded clip length the time-sharded forward takes over
    ``n_shards``: divisible by n_shards * 2^(depth-1) with >= 16 frames of
    headroom and at least 48 frames per shard (time_shard.py:309-317)."""
    unit = n_shards * 2 ** (depth - 1)
    t_pad = -(-(t_valid + 16) // unit) * unit
    return max(t_pad, 48 * n_shards)


@torch.inference_mode()
def whole_clip_forward(model: PerformanceNet, roll: torch.Tensor, cond: torch.Tensor,
                       onoff: torch.Tensor) -> torch.Tensor:
    """One forward over the whole unpadded clip: roll and onoff (1, T, 128),
    cond (1, T, 1025) -> (1, t_out, 1025) float32, InstanceNorm statistics
    over all T frames.

    Raises ValueError for a clip shorter than one frame at the deepest
    level (2^(depth-1) frames), which only the padded sharded forward takes.
    """
    t = roll.shape[1]
    depth = model.cfg.depth
    if t < 2 ** (depth - 1):
        raise ValueError(f"a {t}-frame clip is shorter than the {2 ** (depth - 1)} "
                         "frames the unpadded forward needs")
    out = model(roll.float(), cond, onoff.float())
    t_out = time_sharded_output_length(t, depth)
    if out.shape[1] != t_out:
        raise RuntimeError(f"forward gave {out.shape[1]} frames for a {t}-frame clip, "
                           f"expected {t_out}")
    return out.float()


# ---- the per-rank ops (channel-first, time last) --------------------------

def shard_time(x: torch.Tensor, mesh, axis_name: str = "time") -> torch.Tensor:
    """This rank's equal slice of a whole (B, T, C) clip along T."""
    return comm.local_slice(x, pmesh.axis_group(mesh, axis_name), 1).contiguous()


def halo_exchange(x: torch.Tensor, group, h: int = 1) -> torch.Tensor:
    """(B, C, T_loc) -> (B, C, T_loc + 2h): the left neighbour's last h
    frames before, the right neighbour's first h after; zeros at the
    clip's first and last rank."""
    from_left, from_right = comm.neighbor_exchange(x[..., -h:], x[..., :h], group)
    return torch.cat([from_left, x, from_right], dim=-1)


def _valid_mask(t_loc: int, t_valid: int, group, device, dtype) -> torch.Tensor:
    """(1, 1, T_loc) mask of this rank's global positions < t_valid."""
    pos = comm.group_rank(group) * t_loc + torch.arange(t_loc, device=device)
    return (pos < t_valid).to(dtype)[None, None, :]


def _mask(x: torch.Tensor, t_valid: int, group) -> torch.Tensor:
    return x * _valid_mask(x.shape[-1], t_valid, group, x.device, x.dtype)


def sharded_instance_norm(x: torch.Tensor, group, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the GLOBAL time axis of a time-sharded (B, C, T_loc)."""
    x32 = x.to(stat_dtype(x.dtype))
    t_total = x.shape[-1] * comm.group_size(group)
    s1 = comm.all_reduce_sum(x32.sum(-1, keepdim=True), group)
    s2 = comm.all_reduce_sum((x32 * x32).sum(-1, keepdim=True), group)
    mean = s1 / t_total
    var = s2 / t_total - mean * mean
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def masked_instance_norm(x: torch.Tensor, t_valid: int, group,
                         eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the valid prefix of the global time axis
    (two-pass, float32 statistics); equals ``layers.instance_norm`` on the
    unpadded clip, and the padding comes out exactly zero."""
    dt = stat_dtype(x.dtype)
    m = _valid_mask(x.shape[-1], t_valid, group, x.device, dt)
    x32 = x.to(dt) * m
    mean = comm.all_reduce_sum(x32.sum(-1, keepdim=True), group) / t_valid
    cen = (x32 - mean) * m
    var = comm.all_reduce_sum((cen * cen).sum(-1, keepdim=True), group) / t_valid
    return (cen * torch.rsqrt(var + eps)).to(x.dtype)


def sharded_conv_block(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, group,
                       eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """conv k=3 p=1 -> global InstanceNorm -> LeakyReLU on a time-sharded
    (B, Cin, T_loc); ``weight`` (Cout, Cin, 3), ``bias`` (Cout,)."""
    y = F.conv1d(halo_exchange(x, group, 1), weight, bias)
    return leaky_relu(sharded_instance_norm(y, group, eps), slope)


def _shift_right(x: torch.Tensor, s: int, group) -> torch.Tensor:
    """Global right shift by s frames (s zeros in front): y[t] = x[t - s]."""
    if s == 0:
        return x
    from_left, _ = comm.neighbor_exchange(x[..., -s:], None, group)
    return torch.cat([from_left, x[..., :-s]], dim=-1)


def _shift_left(x: torch.Tensor, s: int, group) -> torch.Tensor:
    """Global left shift by s frames (the first s dropped): y[t] = x[t + s]."""
    if s == 0:
        return x
    _, from_right = comm.neighbor_exchange(None, x[..., :s], group)
    return torch.cat([x[..., s:], from_right], dim=-1)


def _conv1x3_halo(x: torch.Tensor, conv, group) -> torch.Tensor:
    """``layers.Conv1x3`` (k=3, s=1, p=1) on a time-sharded masked input."""
    xc, w, b = conv._cast(halo_exchange(x, group, 1))
    return F.conv1d(xc, w, b)


def _conv_transpose_s2(x: torch.Tensor, conv, group) -> torch.Tensor:
    """``layers.ConvTranspose1dTorch`` (kernel k <= 6, stride 2, padding 1)
    on a time-sharded masked input: this rank's 2*T_loc output frames
    (valid prefix 2*t_valid + k - 4). The input-dilated sequence D
    (D[2t] = x[t]) is built from a 2-frame halo; output j correlates
    D[j - (k - 2) : j + 1] with the flipped kernel."""
    k = conv.weight.shape[-1]
    t = x.shape[-1]
    xe = halo_exchange(x, group, 2)  # (B, C, T_loc + 4)
    b, c, te = xe.shape
    d = torch.stack([xe, torch.zeros_like(xe)], dim=-1).reshape(b, c, 2 * te)
    lo = 6 - k  # output 0's window start (a 2-frame halo is 4 dilated frames)
    xc, w, bias = conv._cast(d[..., lo:lo + 2 * t + k - 1])
    return F.conv1d(xc, w.permute(1, 0, 2).flip(-1), bias)


def _conv_transpose_s1_k3(x: torch.Tensor, conv, group) -> torch.Tensor:
    """ConvTranspose1d(kernel 3, stride 1, padding 1), the head
    (model.py:242): correlation with the flipped kernel at padding 1."""
    xc, w, b = conv._cast(halo_exchange(x, group, 1))
    return F.conv1d(xc, w.permute(1, 0, 2).flip(-1), b)


def _crop_and_concat(up: torch.Tensor, t_up: int, bypass: torch.Tensor, t_by: int,
                     group) -> torch.Tensor:
    """``layers.crop_and_concat`` on time-sharded tensors: the centre
    crop (or pad) of the bypass is a global shift by the static amount."""
    c = (t_by - t_up) // 2
    if c > 0:
        bypass = _shift_left(bypass, c, group)
    elif c < 0:
        bypass = _shift_right(bypass, -c, group)
    bypass = _mask(bypass, t_up, group)  # right-crop any leftover frame
    return torch.cat([up, bypass.to(up.dtype)], dim=1)


def _in_lrelu(x, t_valid, group, slope, eps):
    return leaky_relu(masked_instance_norm(x, t_valid, group, eps), slope)


def sharded_down_conv(block, x: torch.Tensor, t_valid: int, group):
    """Time-sharded ``layers.DownConv`` (reference model.py:34-53).
    Returns (pooled, t_pooled, before_pool, t_before)."""
    for conv in (block.conv1, block.conv2):
        x = _in_lrelu(_conv1x3_halo(x, conv, group), t_valid, group, block.slope, block.eps)
    before, t_before = x, t_valid
    if block.pooling:  # shard-local: T_loc is even
        x = _mask(F.max_pool1d(x, kernel_size=2, stride=2), t_valid // 2, group)
        t_valid //= 2
    return x, t_valid, before, t_before


def sharded_up_conv(up, skip: torch.Tensor, t_skip: int, dec: torch.Tensor, t_dec: int,
                    cond: torch.Tensor | None, t_cond: int, group):
    """Time-sharded ``layers.UpConv`` (reference model.py:56-90).
    Returns (x, t_up)."""
    k = up.upconv.weight.shape[-1]
    t_up = 2 * t_dec + k - 4  # torch (T - 1) * 2 - 2 + k
    x = _in_lrelu(_conv_transpose_s2(dec, up.upconv, group), t_up, group, up.slope, up.eps)
    x = _crop_and_concat(x, t_up, skip, t_skip, group)
    x = _in_lrelu(_conv1x3_halo(x, up.conv1, group), t_up, group, up.slope, up.eps)
    if cond is not None:
        x = _crop_and_concat(x, t_up, cond, t_cond, group)
    x = _in_lrelu(_conv1x3_halo(x, up.conv2, group), t_up, group, up.slope, up.eps)
    return x, t_up


def sharded_dense_concat(dc, midi: torch.Tensor, audio: torch.Tensor, t_valid: int,
                         group) -> torch.Tensor:
    """Time-sharded ``layers.DenseConcat`` (model.py:93-108): pointwise over
    time, so local; deterministic (no dropout). Audio first, as the model."""
    dt = dc.compute_dtype
    x = torch.cat([audio.to(dt), midi.to(dt)], dim=1)
    for fc in (dc.fc1, dc.fc2):
        x = _mask(F.relu(fc(x)), t_valid, group)  # relu(bias) leaks into the padding
    return x


def sharded_mbr_block(mbr, x: torch.Tensor, t_valid: int, group) -> torch.Tensor:
    """Time-sharded ``layers.MBRBlock`` (model.py:143-174)."""
    if mbr.compat_noop:
        return x * 2.0
    outs = []
    for band, c1, c2 in zip(torch.chunk(x, mbr.num_bands, dim=1), mbr.conv_list1,
                            mbr.conv_list2):
        t = _in_lrelu(_conv1x3_halo(band, c1, group), t_valid, group, mbr.slope, mbr.eps)
        outs.append(masked_instance_norm(_conv1x3_halo(t, c2, group), t_valid, group,
                                         mbr.eps))
    return x + torch.cat(outs, dim=1)


def _forward_local(model: PerformanceNet, xm: torch.Tensor, xa: torch.Tensor,
                   xc: torch.Tensor, t_valid: int, group) -> torch.Tensor:
    """Per-rank body of the time-sharded forward: channel-first local
    shards of the zero-padded clip -> (B, bins, T_loc) float32, zero past
    the output's valid length."""
    cfg = model.cfg
    midi_skips, audio_skips = [], []
    h, t = xm, t_valid
    for down in model.down_convs:
        h, t, before, tb = sharded_down_conv(down, h, t, group)
        midi_skips.append((before, tb))
    a, ta = xa, t_valid
    for down in model.down_convs_audio:
        a, ta, before, tb = sharded_down_conv(down, a, ta, group)
        audio_skips.append((before, tb))
    assert t == ta, (t, ta)
    x = sharded_dense_concat(model.dense_concats[0], h, a, t, group)
    conds = []
    oc, tc = xc, t_valid
    depth = cfg.onset_encoder_depth
    for i, down in enumerate(model.onset_offset_encoder.down_convs):
        oc, tc, _, _ = sharded_down_conv(down, oc, tc, group)
        if i > depth - 3:  # the last two pooled maps
            conds.append((oc, tc))
    t_dec = t
    for i, up in enumerate(model.up_convs):
        skip_m, ts = midi_skips[-(i + 2)]
        skip_a, _ = audio_skips[-(i + 2)]
        skip = sharded_dense_concat(model.dense_concats[i + 1], skip_m, skip_a, ts, group)
        # reference indexing quirk: Onoff_Conditions[i-1] => [-1] then [0]
        ci, tci = conds[i - 1] if up.has_condition else (None, 0)
        x, t_dec = sharded_up_conv(up, skip, ts, x, t_dec, ci, tci, group)
    for j in range(1, 5):
        x = sharded_mbr_block(getattr(model, f"MBRBlock{j}"), x, t_dec, group)
    x = _conv_transpose_s1_k3(x, model.lastconv, group)
    x = _mask(leaky_relu(x, cfg.leaky_relu_slope), t_dec, group)
    return x.to(stat_dtype(x.dtype))


def make_time_sharded_forward(model: PerformanceNet, mesh, t_valid: int,
                              axis_name: str = "time"):
    """The one-pass whole-clip forward with the time axis sharded over
    ``mesh``'s ``axis_name`` (the reference's inference semantics,
    model/inference.py:82-84: the whole clip in one fully-convolutional
    forward, InstanceNorm statistics over all of it).

    Returns (fn, t_pad, t_out): ``fn(midi, audio, cond)`` takes this rank's
    (B, t_pad / n, C) slices (``shard_time``) of the clip zero-padded to
    t_pad frames and returns its (B, t_pad / n, bins) slice of the output,
    whose frames [0, t_out) are valid and the rest zero. Every rank of the
    axis calls it together.
    """
    group = pmesh.axis_group(mesh, axis_name)
    n = comm.group_size(group)
    depth = model.cfg.depth
    t_pad = padded_length(t_valid, n, depth)
    t_out = time_sharded_output_length(t_valid, depth)

    def fn(xm, xa, xc):
        cf = [v.transpose(1, 2) for v in (xm, xa, xc)]
        return _forward_local(model, *cf, t_valid, group).transpose(1, 2)

    return fn, t_pad, t_out


class TimeShardedTrainer:
    """Fine-tuning on long clips with the time axis sharded over a mesh
    axis (the JAX package's ``make_time_sharded_train_step``): L1 over the
    valid output frames (the reference's train loss, model/train.py:132),
    deterministic (no dropout), and Adam at ``learning_rate`` (optax's
    ``adam`` defaults), updating ``model`` in place. Inputs are this rank's
    (B, t_pad / n, C) slices of the zero-padded clip; targets are zero past
    ``t_out``."""

    def __init__(self, model: PerformanceNet, mesh, t_valid: int,
                 learning_rate: float = 1e-4, axis_name: str = "time"):
        self.model = model
        self.group = pmesh.axis_group(mesh, axis_name)
        self.t_valid = t_valid
        depth = model.cfg.depth
        self.t_pad = padded_length(t_valid, comm.group_size(self.group), depth)
        self.t_out = time_sharded_output_length(t_valid, depth)
        dev = next(model.parameters()).device
        self.optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8,
                                          fused=True if dev.type == "cuda" else None)

    def _loss_backward(self, xm, xa, xc, target) -> torch.Tensor:
        """Back-propagates this rank's share of the loss, sums the
        parameters' gradients over the axis; returns the global loss."""
        self.optimizer.zero_grad(set_to_none=True)
        cf = [v.transpose(1, 2) for v in (xm, xa, xc)]
        pred = _forward_local(self.model, *cf, self.t_valid, self.group)
        m = _valid_mask(pred.shape[-1], self.t_out, self.group, pred.device, pred.dtype)
        local = torch.sum(torch.abs(pred - target.transpose(1, 2).to(pred.dtype)) * m)
        denom = xm.shape[0] * self.t_out * pred.shape[1]
        (local / denom).backward()
        for p in self.model.parameters():
            if p.grad is not None:
                comm.all_reduce_(p.grad, self.group)
        return comm.all_reduce_(local.detach(), self.group) / denom

    def value_and_grad(self, xm, xa, xc, target):
        """(global loss, {parameter name: whole gradient}), no update."""
        loss = self._loss_backward(xm, xa, xc, target)
        return loss, {n: p.grad.clone() for n, p in self.model.named_parameters()}

    def step(self, xm, xa, xc, target) -> torch.Tensor:
        """One Adam step; returns the global loss."""
        loss = self._loss_backward(xm, xa, xc, target)
        self.optimizer.step()
        return loss


def make_time_sharded_train_step(model: PerformanceNet, mesh, t_valid: int,
                                 learning_rate: float = 1e-4,
                                 axis_name: str = "time") -> TimeShardedTrainer:
    return TimeShardedTrainer(model, mesh, t_valid, learning_rate, axis_name)
