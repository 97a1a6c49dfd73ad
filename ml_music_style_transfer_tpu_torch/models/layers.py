"""PerformanceNet building blocks in PyTorch.

Counterpart of the JAX package's ``models/layers.py`` (reference
model/model.py:14-174). The JAX model is channel-last (B, T, C); these
blocks run channel-first (B, C, T), PyTorch's convolution layout, and the
model converts at its public edge. Parameter names and layouts are the
reference's (Conv1d weight (out, in, k), ConvTranspose1d weight
(in, out, k), Linear weight (out, in)), so a reference ``state_dict`` loads
with ``strict=True``.

``compute_dtype`` follows the JAX model: conv and linear inputs, weights and
biases are cast to it (bfloat16 by default) while parameters stay float32;
InstanceNorm statistics are float32 and its output returns to the compute
dtype (a float64 compute dtype keeps float64 statistics, for the training
tests' float64 yardstick). Convolutions and linears are library calls
(``torch.nn.functional``), as the JAX model leaves them to XLA outside any
Pallas kernel. DenseConcat's training-mode dropout is the hand-written
Philox kernel (``ops/kernels/dropout.py``).

Tensor parallelism (the JAX package's ``tp_constrain``,
``performance_net.py:65,86,92,100``, and ``parallel/mesh.py``'s
``activation_constrainer``): ``_Affine.shard_`` keeps this rank's slice of
a weight along the dim ``parallel/mesh.param_shard_dim`` names. A sharded
conv or transposed conv computes its slice of the output channels from
the whole input; InstanceNorm and LeakyReLU act per channel, so the block
stays on the slice, and ``full`` joins the channels before the next conv
(``parallel/comm.gather_channels``). DenseConcat's fc1 is column-parallel
and fc2 row-parallel, whose partial outputs are summed over the model
axis. A sharded module loads the whole tensors of an unsharded
``state_dict`` (each rank keeps its slice).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import dropout as _dropout
from ..parallel import comm


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32: bf16/f16 -> f32, f32 -> f32, f64 -> f64."""
    return torch.promote_types(dtype, torch.float32)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the time axis of (B, C, T), float32 statistics
    (torch.nn.InstanceNorm1d with affine=False, track_running_stats=False)."""
    x32 = x.to(stat_dtype(x.dtype))
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def fast_dropout(x: torch.Tensor, seed: int, call_index: int, rate: float) -> torch.Tensor:
    """Dropout through the Philox kernel: ``x * mask`` with the mask of
    (seed, call_index), gradient ``grad * mask`` (the JAX package's
    ``layers.fast_dropout``, layers.py:49-67, with a seed and call index in
    place of a JAX key), through the ``mmst_torch::dropout_apply`` operator."""
    return _dropout.dropout(x.contiguous(), seed, call_index, rate)


def crop_and_concat(upsampled: torch.Tensor, bypass: torch.Tensor) -> torch.Tensor:
    """Channel-concat after reconciling time lengths (reference model.py:71-78).

    Centre-crops (or pads) ``bypass`` to the upsampled length with the
    reference's floor-division / negative-F.pad arithmetic, then right-crops
    any leftover odd frame. Channel-first: time is the last axis.
    """
    t_up = upsampled.shape[-1]
    t_by = bypass.shape[-1]
    c = (t_by - t_up) // 2  # python floor division, as in the reference
    if c > 0:
        bypass = bypass[..., c : t_by - c]
    elif c < 0:
        bypass = F.pad(bypass, (-c, -c))
    t_now = bypass.shape[-1]
    if t_now > t_up:
        bypass = bypass[..., :t_up]
    elif t_now < t_up:  # cannot occur with floor division; keep the guard
        bypass = F.pad(bypass, (0, t_up - t_now))
    return torch.cat([upsampled, bypass], dim=1)


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dt


class _Affine(nn.Module):
    """A weight of ``shape`` plus a bias of ``n_bias``, float32, uninitialised
    (the model initialises every parameter from one generator).

    ``tp_group`` is None, or the model-axis group over which ``shard_``
    split the weight along ``tp_dim`` (the bias too when ``tp_bias``)."""

    def __init__(self, shape, n_bias: int, compute_dtype: str, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(n_bias, dtype=torch.float32, device=device))
        self.compute_dtype = _dtype(compute_dtype)
        self.tp_group, self.tp_dim, self.tp_bias = None, None, False

    def _cast(self, x):
        dt = self.compute_dtype
        return x.to(dt), self.weight.to(dt), self.bias.to(dt)

    @torch.no_grad()
    def shard_(self, group, dim: int, bias: bool) -> None:
        """Keep this rank's slice of the weight along ``dim`` (and of the
        bias where ``bias``)."""
        self.tp_group, self.tp_dim, self.tp_bias = group, dim, bias
        self.weight = nn.Parameter(comm.local_slice(self.weight, group, dim).contiguous())
        if bias:
            self.bias = nn.Parameter(comm.local_slice(self.bias, group, 0).contiguous())

    def tp_dims(self) -> dict[str, int]:
        """{parameter name: sharded dim} of this module."""
        if self.tp_group is None:
            return {}
        return {"weight": self.tp_dim, **({"bias": 0} if self.tp_bias else {})}

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a whole tensor (an unsharded state_dict) loads as this rank's slice
        for name, dim in self.tp_dims().items():
            key = prefix + name
            t = state_dict.get(key)
            if t is not None and t.shape != getattr(self, name).shape:
                state_dict[key] = comm.local_slice(t, self.tp_group, dim)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _column_input(self, x):
        """The whole input of a layer whose outputs are sharded: its
        gradient is summed over the model axis."""
        return comm.copy_to_group(x, self.tp_group) if self.tp_group is not None else x

    def _bias_slice(self, b):
        """The bias of this rank's output channels. A conv's bias stays
        whole on every rank (the JAX rule): its gradient, nonzero on this
        rank's slice only, is summed over the model axis."""
        if self.tp_group is None or self.tp_bias:
            return b
        return comm.local_slice(comm.copy_to_group(b, self.tp_group), self.tp_group, 0)

    def full(self, y):
        """``y`` with every output channel: the slices joined (channel
        dim 1) when the output channels are sharded."""
        if self.tp_group is None:
            return y
        return comm.gather_channels(y, self.tp_group, 1)


class Conv1x3(_Affine):
    """k=3, s=1, p=1 conv (reference conv1x3, model.py:14-22)."""

    def __init__(self, in_ch: int, out_ch: int, compute_dtype: str = "bfloat16", device=None):
        super().__init__((out_ch, in_ch, 3), out_ch, compute_dtype, device)

    def forward(self, x):
        x, w, b = self._cast(self._column_input(x))
        return F.conv1d(x, w, self._bias_slice(b), padding=1)


class ConvTranspose1dTorch(_Affine):
    """torch.nn.ConvTranspose1d(kernel, stride, padding): output length
    (T-1)*stride - 2*padding + kernel (the decoder's 53->108->216->431->860)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 2,
                 padding: int = 1, compute_dtype: str = "bfloat16", device=None):
        super().__init__((in_ch, out_ch, kernel), out_ch, compute_dtype, device)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x, w, b = self._cast(self._column_input(x))
        return F.conv_transpose1d(x, w, self._bias_slice(b), stride=self.stride,
                                  padding=self.padding)


class Linear(_Affine):
    """Linear over the channel axis of a channel-first (B, C, T) tensor.

    Sharded on dim 0 it is column-parallel (whole input, this rank's
    output channels); on dim 1 row-parallel (this rank's input channels,
    partial outputs summed over the model axis, then the whole bias)."""

    def __init__(self, in_f: int, out_f: int, compute_dtype: str = "bfloat16", device=None):
        super().__init__((out_f, in_f), out_f, compute_dtype, device)

    def forward(self, x):
        if self.tp_dim == 1:
            x, w, b = self._cast(x)
            return comm.reduce_from_group(torch.matmul(w, x), self.tp_group) + b[:, None]
        x, w, b = self._cast(self._column_input(x))
        return torch.matmul(w, x) + b[:, None]


class DownConv(nn.Module):
    """(conv1x3 -> IN -> LeakyReLU) x2, optional MaxPool(2) (model.py:34-53).
    Returns (pooled, before_pool) for the U-Net skips."""

    def __init__(self, in_ch: int, out_ch: int, pooling: bool = True,
                 compute_dtype: str = "bfloat16", slope: float = 0.01,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.conv1 = Conv1x3(in_ch, out_ch, compute_dtype, device)
        self.conv2 = Conv1x3(out_ch, out_ch, compute_dtype, device)
        self.pooling, self.slope, self.eps = pooling, slope, eps

    def forward(self, x):
        x = self.conv1.full(leaky_relu(instance_norm(self.conv1(x), self.eps), self.slope))
        x = self.conv2.full(leaky_relu(instance_norm(self.conv2(x), self.eps), self.slope))
        before_pool = x
        if self.pooling:
            x = F.max_pool1d(x, kernel_size=2, stride=2)
        return x, before_pool


class UpConv(nn.Module):
    """Decoder block (model.py:56-90): transposed-conv upsample -> IN ->
    LReLU, skip fuse (crop_and_concat + conv), optional onset-condition fuse
    + conv."""

    def __init__(self, in_ch: int, out_ch: int, skip_ch: int, cond_ch: int = 0,
                 upconv_kernel: int = 2, compute_dtype: str = "bfloat16",
                 slope: float = 0.01, eps: float = 1e-5, device=None):
        super().__init__()
        self.upconv = ConvTranspose1dTorch(in_ch, out_ch, upconv_kernel, 2, 1,
                                           compute_dtype, device)
        self.conv1 = Conv1x3(out_ch + skip_ch, out_ch, compute_dtype, device)
        self.conv2 = Conv1x3(out_ch + cond_ch, out_ch, compute_dtype, device)
        self.has_condition = cond_ch > 0
        self.slope, self.eps = slope, eps

    def forward(self, skip, dec, cond=None):
        x = self.upconv.full(leaky_relu(instance_norm(self.upconv(dec), self.eps), self.slope))
        x = crop_and_concat(x, skip)
        x = self.conv1.full(leaky_relu(instance_norm(self.conv1(x), self.eps), self.slope))
        if self.has_condition:
            x = crop_and_concat(x, cond)
        x = self.conv2(x)
        return self.conv2.full(leaky_relu(instance_norm(x, self.eps), self.slope))


class DenseConcat(nn.Module):
    """Latent fusion of the MIDI/audio branches (model.py:93-108): channel
    concat [audio, midi], then two Linear+ReLU, each followed in training
    by Dropout(rate) (JAX layers.py:216-232). The two dropouts use call
    indices ``call_index`` and ``call_index + 1`` of ``dropout_seed``."""

    def __init__(self, in_ch: int, intermediate: int, features: int,
                 dropout_rate: float = 0.2, compute_dtype: str = "bfloat16",
                 device=None):
        super().__init__()
        self.fc1 = Linear(in_ch, intermediate, compute_dtype, device)
        self.fc2 = Linear(intermediate, features, compute_dtype, device)
        self.dropout_rate = dropout_rate
        self.compute_dtype = _dtype(compute_dtype)

    def forward(self, midi_embed, audio_embed, deterministic: bool = True,
                dropout_seed: int | None = None, call_index: int = 0):
        train = not deterministic and self.dropout_rate > 0.0
        if train and dropout_seed is None:
            raise ValueError("deterministic=False needs a dropout_seed")
        dt = self.compute_dtype
        x = torch.cat([audio_embed.to(dt), midi_embed.to(dt)], dim=1)
        x = F.relu(self.fc1(x))
        if train:
            # under TP fc1's output is this rank's channel slice: each model
            # rank draws its own mask. fc2's output is whole and the same on
            # every model rank, so its mask is too (the seed unfolded).
            seed1 = dropout_seed
            if self.fc1.tp_group is not None:
                seed1 = _dropout.fold_seed(seed1, comm.group_rank(self.fc1.tp_group))
            x = fast_dropout(x, seed1, call_index, self.dropout_rate)
        x = F.relu(self.fc2(x))
        if train:
            x = fast_dropout(x, dropout_seed, call_index + 1, self.dropout_rate)
        return x


class MBRBlock(nn.Module):
    """Multi-band residual block (model.py:143-174).

    compat_noop=False: the intended residual ``x + concat(band_branches)``,
    each band conv-IN-LReLU-conv-IN. compat_noop=True: the reference's
    literal behaviour, ``2*x`` (its residual add is discarded, model.py:172),
    with no parameters, as in the JAX model.
    """

    def __init__(self, channels: int, num_bands: int, compat_noop: bool = False,
                 compute_dtype: str = "bfloat16", slope: float = 0.01,
                 eps: float = 1e-5, device=None):
        super().__init__()
        if channels % num_bands != 0:
            raise ValueError(f"{channels} channels do not split into {num_bands} bands")
        self.num_bands, self.compat_noop = num_bands, compat_noop
        self.slope, self.eps = slope, eps
        if not compat_noop:
            band = channels // num_bands
            self.conv_list1 = nn.ModuleList(
                [Conv1x3(band, band, compute_dtype, device) for _ in range(num_bands)])
            self.conv_list2 = nn.ModuleList(
                [Conv1x3(band, band, compute_dtype, device) for _ in range(num_bands)])

    def forward(self, x):
        if self.compat_noop:
            return x * 2.0
        bands = torch.chunk(x, self.num_bands, dim=1)
        outs = []
        for band, c1, c2 in zip(bands, self.conv_list1, self.conv_list2):
            t = c1.full(leaky_relu(instance_norm(c1(band), self.eps), self.slope))
            outs.append(c2.full(instance_norm(c2(t), self.eps)))
        return x + torch.cat(outs, dim=1)
