"""The models' channel-last memory (``models/layers.py``), on the CPU: with
the card's entry (``card_entry``, what ``layers.model_input`` does on the
card) the public (B, T, C) forward hands every convolution, and every
convolution's gradient, channels-last tensors; it computes what the
channel-first composition of the same modules computes, to float64
round-off; the DenseConcat dropout masks index each logical (b, c, t)
element as the plain mask of the channel-first contiguous tensor; a conv
weight's gradient has its parameter's strides; a recorded train step
carries the conv counts. On the CPU itself the models enter channel-first."""
import contextlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ml_music_style_transfer_tpu_torch.config import ModelConfig
from ml_music_style_transfer_tpu_torch.models import PerformanceNet, autoencoder, layers
from ml_music_style_transfer_tpu_torch.models import performance_net
from ml_music_style_transfer_tpu_torch.models.autoencoder import (AutoencoderConfig,
                                                                  SpectrogramAutoencoder)
from ml_music_style_transfer_tpu_torch.ops.kernels import dropout as kdropout
from ml_music_style_transfer_tpu_torch.utils import profiling

T = 128  # encoder 128 -> 8 frames, decoder 8 -> 140
PNET_CONV_CALLS = 99  # 10 + 10 encoder, 6 onset, 4 x 3 decoder, 2 x 30 MBR, head
AE_CONV_CALLS = 9


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def card_entry(x, dtype):
    """``layers.model_input`` as it runs on the card: cast to a contiguous
    (B, T, C) tensor, viewed as (B, C, T)."""
    return layers.relayout(x.transpose(1, 2), dtype, False)


@pytest.fixture
def on_card_entry(monkeypatch):
    for mod in (performance_net, autoencoder):
        monkeypatch.setattr(mod, "model_input", card_entry)


def _pnet(dtype="float64"):
    gen = torch.Generator().manual_seed(0)
    return PerformanceNet(ModelConfig(width_mult=1 / 16, compute_dtype=dtype), generator=gen)


def _pnet_inputs(dtype=torch.float64, batch=2):
    gen = torch.Generator().manual_seed(1)
    midi = (torch.rand(batch, T, 128, generator=gen) < 0.05).to(dtype)
    spec = torch.rand(batch, T, 1025, generator=gen, dtype=dtype) * 4.0
    onoff = torch.randint(-1, 2, (batch, T, 128), generator=gen).to(dtype)
    return midi, spec, onoff


def _cf(x):
    """(B, T, C) -> channel-first contiguous (B, C, T)."""
    return x.transpose(1, 2).contiguous()


class ConvCalls(TorchDispatchMode):
    """Records the inputs of every ``aten.convolution`` and
    ``aten.convolution_backward``, as the operator got them."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.calls.append((func.overloadpacket.__name__, args))
        return func(*args, **(kwargs or {}))


def _channels_innermost(t: torch.Tensor) -> bool:
    return t.dim() == 4 and t.stride(1) == 1 and t.stride(-1) != 1


@contextlib.contextmanager
def _counted():
    before = dict(layers.CONV_COUNTS)
    moved = {}
    yield moved
    moved.update({k: v - before[k] for k, v in layers.CONV_COUNTS.items()})


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _assert_close(got, want, scale=None):
    """Equal to float64 round-off: 1e-9 relative, 1e-7 of ``scale`` (the
    tensor's peak, or the largest gradient of the model) absolute. A weight
    gradient sums B x T products far larger than itself, so both orders of
    summation differ there by an ulp of those sums: up to 2**-30, 6e-9 of
    the largest gradient, in the tiny model; a conv bias before InstanceNorm
    has a gradient of round-off alone. A wrong layout is off by O(1)."""
    scale = float(want.abs().max()) if scale is None else scale
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-7 * scale)


def _assert_grads_close(got, want):
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        _assert_close(got[k], g, scale)


def test_performancenet_runs_channel_last_and_matches_channel_first(on_card_entry):
    model = _pnet()
    midi, spec, onoff = _pnet_inputs()
    calls = ConvCalls()
    with _counted() as n, calls:
        out = model(midi, spec, onoff)
        out.square().mean().backward()
    assert n == {"conv_calls": PNET_CONV_CALLS, "conv_channel_last_calls": PNET_CONV_CALLS}
    # the output leaves channel-first, as the loss's target is stored
    assert out.shape == (2, 140, 1025) and out.transpose(1, 2).is_contiguous()
    fwd = [a for name, a in calls.calls if name == "convolution"]
    bwd = [a for name, a in calls.calls if name == "convolution_backward"]
    # each conv's input and weight gradients, apart: the first conv of each
    # of the three encoders takes the model's input, which has none
    masks = [tuple(a[-1]) for a in bwd]
    assert len(fwd) == PNET_CONV_CALLS
    assert masks.count((False, True, False)) == PNET_CONV_CALLS
    assert masks.count((True, False, False)) == PNET_CONV_CALLS - 3 == len(bwd) - PNET_CONV_CALLS
    for grad_out, x, w, *_ in bwd:
        assert all(map(_channels_innermost, (grad_out, x, w)))
    for x, w, *_ in fwd:
        assert _channels_innermost(x) and _channels_innermost(w)
    cl_out, cl_grads = out.detach(), _grads(model)

    model.zero_grad(set_to_none=True)
    with _counted() as n:
        out = model.forward_channel_first(_cf(midi), _cf(spec), _cf(onoff)).transpose(1, 2)
        out.square().mean().backward()
    assert n == {"conv_calls": PNET_CONV_CALLS, "conv_channel_last_calls": 0}
    _assert_close(cl_out, out.detach())
    _assert_grads_close(cl_grads, _grads(model))


def test_channel_last_model_is_the_channel_first_one_bit_for_bit(on_card_entry, monkeypatch):
    """With each convolution computed channel-first (what the card falls
    back to where its NHWC engine sums otherwise than its NCHW one), every
    other step of the channel-last model (InstanceNorm, relayouts,
    concatenations, DenseConcat, the head) gives the channel-first model's
    numbers bit for bit, forward and backward."""
    monkeypatch.setattr(layers, "_nhwc_agrees", lambda key, part, tensors: False)
    model = _pnet("float32")
    midi, spec, onoff = _pnet_inputs(torch.float32)
    seed = 2**40 + 7
    # the target stored as the data path stores it: the STFT's (B, bins, T)
    target = torch.rand(2, 1025, 140, generator=torch.Generator().manual_seed(9)).transpose(1, 2)
    out = model(midi, spec, onoff, deterministic=False, dropout_seed=seed)
    (out - target).abs().mean().backward()
    cl_out, cl_grads = out.detach(), _grads(model)
    model.zero_grad(set_to_none=True)
    out = model.forward_channel_first(_cf(midi), _cf(spec), _cf(onoff), deterministic=False,
                                      dropout_seed=seed).transpose(1, 2)
    (out - target).abs().mean().backward()
    assert torch.equal(cl_out, out.detach())
    grads = _grads(model)
    conv_bias = {f"{n}.bias" for n, m in model.named_modules()
                 if isinstance(m, (layers.Conv1x3, layers.ConvTranspose1dTorch))}
    assert all(torch.equal(cl_grads[k], g) for k, g in grads.items() if k not in conv_bias)
    # a conv bias's gradient: on the card the channel-first backward's own
    # sum (PyTorch sums the bias after cuDNN); on the CPU oneDNN sums it
    # inside the channel-first convolution, so here it agrees to round-off
    scale = max(float(g.abs().max()) for g in grads.values())
    for k in conv_bias:
        torch.testing.assert_close(cl_grads[k], grads[k], rtol=1e-5, atol=1e-6 * scale)


def test_a_disagreeing_part_is_computed_channel_first_from_then_on(monkeypatch):
    """The first call at a key on the card probes both layouts on seeded
    normal tensors of the live ones' shapes, dtypes and strides, not on the
    live values (zeros here, which sum to the same bits in any order); a
    part whose layouts part runs channel-first from then on, in a training
    step; the CPU is not probed."""
    monkeypatch.setattr(layers, "NHWC_AGREES", {})
    live = torch.zeros(2, 3, 1, 5).to(memory_format=torch.channels_last)
    w = torch.ones(4, 3, 1, 3)
    seen = []

    def part(x, w_, grad, channel_first):  # NHWC sums otherwise: another last bit
        seen.append(x)
        s = x.double().sum()
        return s if channel_first else s * (1 + 1e-12)

    assert torch.equal(part(live, w, None, False), part(live, w, None, True))
    seen.clear()
    card = ("dx", live.shape, w.shape, (), live.dtype, torch.device("cuda"))
    assert layers._nhwc_agrees(card, part, (live, w, None)) is False
    assert layers.NHWC_AGREES[card] is False and len(seen) == 2
    probe = seen[0]
    assert torch.equal(seen[1], probe) and bool(probe.abs().sum() > 0)
    assert (probe.shape, probe.stride(), probe.dtype) == (live.shape, live.stride(), live.dtype)
    assert layers._nhwc_agrees(card, part, (live, w, None)) is False and len(seen) == 2
    agree = ("dw", live.shape, w.shape, (), live.dtype, torch.device("cuda"))
    assert layers._nhwc_agrees(agree, lambda x, w_, g, cf: x.sum(), (live, w, None)) is True
    assert layers.NHWC_AGREES[agree] is True
    cpu = ("y", live.shape, w.shape, (), live.dtype, torch.device("cpu"))
    assert layers._nhwc_agrees(cpu, part, (live, w, None)) is True
    assert len(seen) == 2 and cpu not in layers.NHWC_AGREES

    # _conv takes the channel-first part where the layouts part
    ran = []
    monkeypatch.setattr(layers, "_conv_part",
                        lambda conv, name, x, w_, g, first: ran.append((name, first)))
    monkeypatch.setattr(layers, "_nhwc_agrees", lambda key, p, tensors: key[0] != "dx")
    for name in ("y", "dx", "dw"):
        layers._conv((), name, live, w, live)
    assert ran == [("y", False), ("dx", True), ("dw", False)]


def test_autoencoder_runs_channel_last_and_matches_channel_first(on_card_entry):
    model = SpectrogramAutoencoder(AutoencoderConfig(n_bins=24, width=8, compute_dtype="float64"),
                                   generator=torch.Generator().manual_seed(0))
    x = torch.rand(3, 32, 24, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    calls = ConvCalls()
    with _counted() as n, calls:
        out = model(x)
        out.square().mean().backward()
    assert n == {"conv_calls": AE_CONV_CALLS, "conv_channel_last_calls": AE_CONV_CALLS}
    assert out.shape == x.shape and out.transpose(1, 2).is_contiguous()
    assert all(_channels_innermost(a[0]) for _, a in calls.calls)
    cl_out, cl_grads = out.detach(), _grads(model)

    # the same modules composed on channel-first contiguous tensors
    model.zero_grad(set_to_none=True)
    with _counted() as n:
        h, _ = model.down_0(_cf(x))
        h, _ = model.down_1(h)
        h, _ = model.bottleneck(h)
        h = layers.leaky_relu(layers.instance_norm(model.up_0(h)))
        h = layers.leaky_relu(layers.instance_norm(model.up_1(h)))
        out = torch.relu(model.head(h)).float().transpose(1, 2)
        out.square().mean().backward()
    assert n == {"conv_calls": AE_CONV_CALLS, "conv_channel_last_calls": 0}
    _assert_close(cl_out, out.detach())
    _assert_grads_close(cl_grads, _grads(model))


def test_dropout_masks_index_the_channel_first_tensor(monkeypatch, on_card_entry):
    """The ten masks of one seed: each dropout takes a channel-first
    contiguous tensor and returns it times the plain mask of that tensor's
    shape, so a logical (b, c, t) element keeps the mask it had."""
    seen = []
    dropout = layers.fast_dropout

    def recording(x, seed, call_index, rate):
        y = dropout(x, seed, call_index, rate)
        seen.append((x.detach(), seed, call_index, rate, y.detach()))
        return y

    monkeypatch.setattr(layers, "fast_dropout", recording)
    model = _pnet("float32")
    seed = 2**63 + 12345
    out = model(*_pnet_inputs(torch.float32), deterministic=False, dropout_seed=seed)
    out.mean().backward()
    assert [s[2] for s in seen] == list(range(10))
    for x, s, call_index, rate, y in seen:
        assert x.is_contiguous() and s == seed and rate == pytest.approx(0.2)
        mask = kdropout.dropout_mask_reference(seed, call_index, x.shape, rate, x.dtype)
        assert torch.equal(y, x * mask), call_index


@pytest.mark.parametrize("cls,shape", [(layers.Conv1x3, (6, 4)),
                                       (layers.ConvTranspose1dTorch, (4, 6))])
def test_conv_weight_gradient_has_its_parameters_strides(cls, shape):
    conv = cls(*shape, compute_dtype="bfloat16") if cls is layers.Conv1x3 else \
        cls(*shape, kernel=4, compute_dtype="bfloat16")
    with torch.no_grad():
        conv.weight.normal_(generator=torch.Generator().manual_seed(3))
        conv.bias.zero_()
    x = torch.randn(2, 10, shape[0]).transpose(1, 2)
    assert layers.channel_last(x)
    y = conv(x)
    assert layers.channel_last(y)
    y.float().square().sum().backward()
    g = conv.weight.grad
    assert g.dtype == torch.float32 and g.stride() == conv.weight.stride() and g.is_contiguous()
    want = cls(*shape, compute_dtype="bfloat16") if cls is layers.Conv1x3 else \
        cls(*shape, kernel=4, compute_dtype="bfloat16")
    want.load_state_dict(conv.state_dict())
    want(x.contiguous()).float().square().sum().backward()
    torch.testing.assert_close(g, want.weight.grad, rtol=2e-2, atol=2e-2 * float(g.abs().max()))


def test_the_cpu_entry_is_channel_first_and_the_cards_channel_last():
    x = torch.rand(2, 7, 5)
    got = layers.model_input(x, torch.float64)
    assert got.dtype == torch.float64 and got.is_contiguous() and not layers.channel_last(got)
    assert torch.equal(got, x.transpose(1, 2).double())
    for dt in (torch.float32, torch.bfloat16):  # a strided input is copied in both
        card = card_entry(x.transpose(0, 1).contiguous().transpose(0, 1), dt)
        assert layers.channel_last(card) and torch.equal(card, x.transpose(1, 2).to(dt))
    midi, spec, onoff = _pnet_inputs(batch=1)
    with _counted() as n:
        _pnet()(midi, spec, onoff)
    assert n == {"conv_calls": PNET_CONV_CALLS, "conv_channel_last_calls": 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_instance_norm_sums_in_the_channel_first_order(dtype):
    """Channel-last InstanceNorm is the channel-first one bit for bit,
    forward and backward, and keeps its input's layout."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 50, 16, generator=gen).to(dtype)
    g = torch.randn(3, 16, 50, generator=gen).to(dtype)
    cl = x.transpose(1, 2).detach().requires_grad_()
    cf = x.transpose(1, 2).contiguous().requires_grad_()
    y_cl, y_cf = layers.instance_norm(cl), layers.instance_norm(cf)
    assert layers.channel_last(y_cl) and y_cf.is_contiguous() and y_cl.dtype == dtype
    assert torch.equal(y_cl, y_cf)
    y_cl.backward(g.transpose(1, 2).contiguous().transpose(1, 2))
    y_cf.backward(g)
    assert layers.channel_last(cl.grad) and torch.equal(cl.grad, cf.grad)


def test_layout_helpers_keep_the_first_tensors_layout():
    a = torch.randn(2, 5, 3).transpose(1, 2)     # channel-last (2, 3, 5)
    b = torch.randn(2, 4, 5)                     # channel-first (2, 4, 5)
    cat = layers.cat_channels([a, b])
    assert layers.channel_last(cat) and torch.equal(cat, torch.cat([a, b], dim=1))
    cat = layers.cat_channels([b, a])
    assert cat.is_contiguous() and torch.equal(cat, torch.cat([b, a], dim=1))
    assert torch.equal(layers.to_channel_last(b), b) and layers.channel_last(
        layers.to_channel_last(b))
    up = torch.randn(2, 7, 3).transpose(1, 2)
    got = layers.crop_and_concat(up, torch.randn(2, 5, 4).transpose(1, 2))
    assert layers.channel_last(got) and got.shape == (2, 7, 7)
    # one frame or one channel: the same memory in both layouts, channel-first
    assert not layers.channel_last(torch.randn(2, 1, 3).transpose(1, 2))
    assert not layers.channel_last(torch.randn(2, 3, 1).transpose(1, 2))


def test_recorded_step_carries_the_conv_counts(on_card_entry):
    model = SpectrogramAutoencoder(AutoencoderConfig(n_bins=16, width=4, compute_dtype="float32"),
                                   generator=torch.Generator().manual_seed(0))
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("train.step", step=True):
            model(torch.rand(2, 16, 16)).mean().backward()
        with profiling.span("train.step", step=True):
            pass
    ran, idle = profiling.spans()
    profiling.clear_spans()
    assert ran.counters == {"conv_calls": AE_CONV_CALLS, "conv_channel_last_calls": AE_CONV_CALLS}
    assert idle.counters == {}
