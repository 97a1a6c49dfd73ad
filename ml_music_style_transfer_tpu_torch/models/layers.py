"""PerformanceNet building blocks in PyTorch.

Counterpart of the JAX package's ``models/layers.py`` (reference
model/model.py:14-174). The JAX model is channel-last (B, T, C); these
blocks take and return channel-first shapes (B, C, T), PyTorch's
convolution layout, so ``dim=1`` is the channel axis everywhere. Parameter
names and layouts are the reference's (Conv1d weight (out, in, k),
ConvTranspose1d weight (in, out, k), Linear weight (out, in)), so a
reference ``state_dict`` loads with ``strict=True``.

Memory layout: a block keeps the memory layout of its input. A training
forward on the card enters channel-last (``model_input``): the models'
public (B, T, C) input, viewed as (B, C, T), is the transpose view of a
contiguous (B, T, C) tensor (``channel_last``), which is the layout
cuDNN's bf16 convolutions run in on Hopper (NHWC). ``Conv1x3`` and
``ConvTranspose1dTorch`` hand such an input to cuDNN as the channels-last
(B, C, 1, T) view with a channels-last weight, so neither the convolution
nor its gradients transpose; their outputs, the elementwise ops, pooling,
padding and ``cat_channels`` stay channel-last. InstanceNorm sums its
statistics over a contiguous time axis in either layout, so the
channel-last model's numbers are the channel-first one's. A channel-first
contiguous input (``parallel/time_shard.py``'s composition,
``PerformanceNet.forward_channel_first`` callers, the models' public
forward on the CPU and in inference, which the host paces at serving's
batches) runs channel-first throughout, through ``F.conv1d``.
``CONV_COUNTS`` counts the convolutions' calls and those that took a
channel-last input; a recorded train step carries both
(``utils/profiling.register_counts``).

``compute_dtype`` follows the JAX model: conv and linear inputs, weights and
biases are cast to it (bfloat16 by default) while parameters stay float32;
InstanceNorm statistics are float32 and its output returns to the compute
dtype (a float64 compute dtype keeps float64 statistics, for the training
tests' float64 yardstick). Convolutions and linears are library calls
(``torch.nn.functional``), as the JAX model leaves them to XLA outside any
Pallas kernel. DenseConcat's training-mode dropout is the hand-written
Philox kernel (``ops/kernels/dropout.py``), over the channel-first
contiguous output of its linears whatever the input's layout, so each
(b, c, t) element keeps its mask.

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

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import dropout as _dropout
from ..ops.kernels import relayout as _relayout
from ..parallel import comm
from ..utils import profiling

# calls of Conv1x3 and ConvTranspose1dTorch in this process, and those whose
# input was channel-last: cuDNN got it with no transpose
CONV_COUNTS = profiling.register_counts({"conv_calls": 0, "conv_channel_last_calls": 0})


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32: bf16/f16 -> f32, f32 -> f32, f64 -> f64."""
    return torch.promote_types(dtype, torch.float32)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the time axis of (B, C, T), float32 statistics
    (torch.nn.InstanceNorm1d with affine=False, track_running_stats=False),
    returned in x's layout.

    The statistics and their gradients are always summed over a contiguous
    time axis: a channel-last x is cast to float32 channel-first and the
    result back to channel-last, each in the pass the casts take anyway
    (``relayout``). Summed in another order, a statistic moves in its last
    float32 bit, which flips a bfloat16 rounding of the output now and then,
    and the random network grows each flip about fiftyfold; so the
    channel-last model keeps the channel-first one's numbers bit for bit."""
    if channel_last(x):
        x32 = relayout(x, stat_dtype(x.dtype), True)
        var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
        return relayout((x32 - mean) * torch.rsqrt(var + eps), x.dtype, False)
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


def channel_last(x: torch.Tensor) -> bool:
    """Whether (B, C, T) ``x`` is stored channel-last: the channels are its
    memory's innermost axis, as in the transpose view of a (B, T, C) tensor
    or a channel slice of one. A tensor whose memory is the same in both
    layouts (one frame, one channel) counts as channel-first."""
    return x.stride(1) == 1 and not x.is_contiguous()


def model_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A model's public (B, T, C) input as the (B, C, T) tensor its first
    convolution takes, cast to ``dtype`` in the same pass (the cast that
    convolution makes anyway).

    Channel-last where autograd records a training forward on the card, so
    cuDNN runs every convolution and its gradients in NHWC: a contiguous
    (B, T, C) input is cast in its own layout, a strided one (the STFT's
    (B, bins, T) spectrogram, viewed as (B, T, bins)) moved by K4 in the
    cast's pass. Channel-first contiguous otherwise: an inference forward
    on the card is paced by the host at serving's batches, where the
    channel-last path's extra calls (its autograd Functions, K4 around
    each InstanceNorm) made it 1.2-2.2x slower at batch 1 and 8; the CPU,
    where oneDNN's channel-last float32 convolution sums a 3075-term
    product 5x further from float64 and the port is held to the JAX
    package; and dtypes K4 does not take."""
    x = x.transpose(1, 2)
    if (x.is_cuda and torch.is_grad_enabled() and x.dtype in _relayout.KERNEL_DTYPES
            and dtype in _relayout.KERNEL_DTYPES):
        return relayout(x, dtype, False)
    # ``to`` keeps a tensor of its own dtype as it is: copy
    return x.to(dtype, memory_format=torch.contiguous_format, copy=not x.is_contiguous())


def relayout(x: torch.Tensor, dtype: torch.dtype, first: bool) -> torch.Tensor:
    """(B, C, T) ``x`` cast to ``dtype`` and stored channel-first contiguous
    (``first``) or channel-last, in one pass (``_stored``). Its gradient
    returns in x's dtype, channel-first: whatever sums it next
    (InstanceNorm's statistics, a conv bias's gradient, the loss) sums over
    a contiguous time axis."""
    return _Relayout.apply(x, dtype, first)


def to_channel_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T) ``x`` stored channel-last (a copy unless it is already)."""
    return x if channel_last(x) else relayout(x, x.dtype, False)


def to_channel_first(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T) ``x`` stored channel-first (a copy where it is channel-last)."""
    return relayout(x, x.dtype, True) if channel_last(x) else x


def _stored(x: torch.Tensor, dtype: torch.dtype, first: bool) -> torch.Tensor:
    """``x`` as ``dtype`` stored channel-first contiguous (``first``) or
    channel-last: a plain cast where it is stored so already, else K4's
    transpose with the cast (``ops/kernels/relayout.py``)."""
    if x.is_contiguous() if first else channel_last(x):
        return x.to(dtype)
    return _relayout.relayout(x, dtype, first)


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype, first):
        ctx.dtype = x.dtype
        y = _stored(x, dtype, first)
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, grad):
        if grad.is_contiguous() and grad.dtype == ctx.dtype:
            return grad, None, None
        return _stored(grad, ctx.dtype, True), None, None


class _BiasAdd(torch.autograd.Function):
    """``y + b[:, None]`` on a channel-last (B, C, T) conv output, as
    PyTorch adds a conv's bias after cuDNN. The bias's gradient sums the
    incoming gradient stored channel-first, as the channel-first
    convolution's backward does (same order, same bits); the output's
    gradient goes on channel-last, cuDNN's layout."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b[:, None]

    @staticmethod
    def backward(ctx, grad):
        first = grad if grad.is_contiguous() else _stored(grad, grad.dtype, True)
        last = grad if channel_last(grad) else _stored(first, grad.dtype, False)
        return last, first.sum((0, 2))


def cat_channels(tensors) -> torch.Tensor:
    """``torch.cat(tensors, dim=1)`` of (B, C, T) tensors, stored in the
    first tensor's layout: where it is channel-last, the concatenation of
    the (B, T, C) views along their last axis, which reads the others in
    whatever layout they come (``torch.cat`` of 3-D tensors always writes
    channel-first)."""
    if not channel_last(tensors[0]):
        return torch.cat(tensors, dim=1)
    return torch.cat([t.transpose(1, 2) for t in tensors], dim=2).transpose(1, 2)


def crop_and_concat(upsampled: torch.Tensor, bypass: torch.Tensor) -> torch.Tensor:
    """Channel-concat after reconciling time lengths (reference model.py:71-78).

    Centre-crops (or pads) ``bypass`` to the upsampled length with the
    reference's floor-division / negative-F.pad arithmetic, then right-crops
    any leftover odd frame. Time is the last axis; the result is stored in
    ``upsampled``'s layout (``cat_channels``).
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
    return cat_channels([upsampled, bypass])


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dt


class _ChannelLastWeight(torch.autograd.Function):
    """A conv weight (n, m, k) as the channels-last (n, m, 1, k) tensor of
    ``dtype`` cuDNN takes beside a channel-last input, cast and permuted in
    one pass; its gradient returns to the parameter's dtype and layout in
    one pass too (a gradient strided otherwise than its parameter would make
    ``AccumulateGrad`` copy it again)."""

    @staticmethod
    def forward(ctx, w, dtype):
        ctx.dtype = w.dtype
        return w.unsqueeze(2).to(dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad):
        return grad.squeeze(2).to(ctx.dtype, memory_format=torch.contiguous_format), None


# {(part, shapes, conv, dtype, device): whether cuDNN's NHWC engine computes
# that part of a convolution ("y", "dx", "dw") bit for bit as its NCHW
# engine does}
NHWC_AGREES: dict = {}


def _nhwc_agrees(key: tuple, part, tensors) -> bool:
    """Whether ``part(*tensors, channel_first)`` gives the same bits in both
    layouts at ``key``. Probed once a key on the card (one host sync, in the
    first step: set-up) on seeded normal tensors of the shapes, dtypes and
    layouts of ``tensors``, never on the live batch, whose values (sparse
    MIDI, a zero gradient) could sum exactly in any order and hide engines
    that part. On the CPU and while PyTorch traces, taken to agree."""
    agrees = NHWC_AGREES.get(key)
    if agrees is None:
        if key[-1].type != "cuda" or torch.compiler.is_compiling():
            return True
        gen = torch.Generator(tensors[0].device).manual_seed(0)
        probe = [None if t is None else
                 torch.empty_like(t).copy_(torch.randn(t.shape, generator=gen, device=t.device))
                 for t in tensors]
        agrees = NHWC_AGREES[key] = torch.equal(part(*probe, False), part(*probe, True))
    return agrees


def _first4(t: torch.Tensor) -> torch.Tensor:
    """A channels-last (B, C, 1, T) tensor stored channel-first."""
    return _stored(t.squeeze(2), t.dtype, True).unsqueeze(2)


def _last4(t: torch.Tensor) -> torch.Tensor:
    """A (B, C, 1, T) tensor stored channels-last."""
    return _stored(t.squeeze(2), t.dtype, False).unsqueeze(2)


def _conv_part(conv: tuple, name: str, x, w, grad, channel_first: bool) -> torch.Tensor:
    """One part of the convolution of channels-last (B, C, 1, T) ``x`` and
    weight ``w`` with ``aten.convolution``'s arguments ``conv`` (no bias):
    its output ("y"), or its input's ("dx") or weight's ("dw") gradient
    given the output's ``grad``; computed in cuDNN's NHWC layout, or in its
    NCHW one (``channel_first``), and returned channels-last."""
    if channel_first:
        x, w = _first4(x), w.contiguous()
        grad = None if grad is None else _first4(grad)
    if name == "y":
        out = torch.ops.aten.convolution(x, w, None, *conv)
    else:
        dw = name == "dw"
        out = torch.ops.aten.convolution_backward(grad, x, w, None, *conv,
                                                  [not dw, dw, False])[dw]
    if not channel_first:
        return out
    return out.contiguous(memory_format=torch.channels_last) if name == "dw" else _last4(out)


def _conv(conv: tuple, name: str, x, w, grad) -> torch.Tensor:
    """``_conv_part`` in NHWC, or, where cuDNN's engines for the two layouts
    part at these shapes (``_nhwc_agrees``), in NCHW."""
    key = (name, x.shape, w.shape, conv, x.dtype, x.device)
    first = not _nhwc_agrees(key, functools.partial(_conv_part, conv, name), (x, w, grad))
    return _conv_part(conv, name, x, w, grad, first)


class _ChannelLastConv(torch.autograd.Function):
    """cuDNN's convolution (``transposed`` or not, no bias) of the
    channels-last (B, C, 1, T) ``x`` and weight ``w``, and its gradients.

    For most shapes cuDNN's NHWC engines compute what its NCHW engines
    compute on the transposed tensors, bit for bit; for some they sum in
    another order (PerformanceNet's data gradients at 107 and 108 frames
    with 3072 and 4096 channels, batch 64, on the H100). Such a part is
    computed channel-first (``_conv``), so what the model learns never
    depends on the layout it runs in: the benchmark's reference sums as the
    channel-first model does, and its limits leave no room for another
    order."""

    @staticmethod
    def forward(ctx, x, w, transposed, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, (1, 1), transposed, (0, 0), 1)
        y = _conv(ctx.conv, "y", x, w, None)
        # channels-last as cuDNN writes it; said so, since a trace's shape
        # rules give a batch of one NCHW strides here (torch.export)
        return y.contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = grad.contiguous(memory_format=torch.channels_last)
        grads = [_conv(ctx.conv, name, x, w, grad) if ctx.needs_input_grad[i] else None
                 for i, name in enumerate(("dx", "dw"))]
        return grads[0], grads[1], None, None, None


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

    def _cast_channel_last(self, x):
        """``_cast`` for a channel-last input: (B, C, 1, T) and (n, m, 1, k)
        channels-last views, the weight's cast and permutation one pass."""
        dt = self.compute_dtype
        return (x.to(dt).unsqueeze(2), _ChannelLastWeight.apply(self.weight, dt),
                self.bias.to(dt))

    def _input(self, x):
        """The conv's input (``_column_input``), counted in ``CONV_COUNTS``;
        and whether it is channel-last."""
        x = self._column_input(x)
        cl = channel_last(x)
        CONV_COUNTS["conv_calls"] += 1
        CONV_COUNTS["conv_channel_last_calls"] += cl
        return x, cl

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
        x, cl = self._input(x)
        if cl:
            x, w, b = self._cast_channel_last(x)
            y = _ChannelLastConv.apply(x, w, False, (1, 1), (0, 1)).squeeze(2)
            return _BiasAdd.apply(y, self._bias_slice(b))
        x, w, b = self._cast(x)
        return F.conv1d(x, w, self._bias_slice(b), padding=1)


class ConvTranspose1dTorch(_Affine):
    """torch.nn.ConvTranspose1d(kernel, stride, padding): output length
    (T-1)*stride - 2*padding + kernel (the decoder's 53->108->216->431->860)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 2,
                 padding: int = 1, compute_dtype: str = "bfloat16", device=None):
        super().__init__((in_ch, out_ch, kernel), out_ch, compute_dtype, device)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x, cl = self._input(x)
        if cl:
            x, w, b = self._cast_channel_last(x)
            y = _ChannelLastConv.apply(x, w, True, (1, self.stride), (0, self.padding)).squeeze(2)
            return _BiasAdd.apply(y, self._bias_slice(b))
        x, w, b = self._cast(x)
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
    indices ``call_index`` and ``call_index + 1`` of ``dropout_seed``.

    The concatenation keeps the inputs' layout: channel-last, fc1's GEMM
    reads it as its transposed operand, with no copy. The linears' outputs,
    the dropouts' and the result are channel-first contiguous whatever the
    input's layout, so the masks index each (b, c, t) element as they
    always have; a channel-last consumer takes the relayout into its own
    pass (``crop_and_concat``'s concatenation, or ``to_channel_last``)."""

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
        x = cat_channels([audio_embed.to(dt), midi_embed.to(dt)])
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
        return x + cat_channels(outs)
