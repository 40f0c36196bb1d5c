"""The eval depthwise convolution kernel (``sykepic_tpu_torch/ops/
depthwise.py``, ``csrc/depthwise.cu``) on the CPU: its plain version against
``F.conv2d(..., groups=C)`` at every shape of ConvNeXt-T and
EfficientNet-B0 and at odd and ragged ones, the wrapper's CPU path, the
launch plan, which convolutions the kernel takes, the rule that sends a
forward to it, ConvNeXt-T's 18 and EfficientNet-B0's 16 call sites run
through the plain version, and the CPU forward unchanged bit for bit. The
kernel itself runs only on the card (``tests/test_torch_gpu.py``).

Tolerance of the plain version against ``F.conv2d``: 1e-5 absolute on
outputs below 8 (inputs of unit variance, taps of variance 1/k^2), for
float32 sums of k^2 products taken in another order.
"""

import pytest
import torch
from torch import nn
from torch.nn import functional as F

from sykepic_tpu_torch.models import convnext, layers, registry
from sykepic_tpu_torch.ops import depthwise

TOL = 1e-5

# (k, stride, map side, channels) of a 180x180 input
CONVNEXT_T = ((7, 1, 45, 96), (7, 1, 22, 192), (7, 1, 11, 384),
              (7, 1, 5, 768))
EFFICIENTNET_B0 = ((3, 1, 90, 32), (3, 2, 90, 96), (3, 1, 45, 144),
                   (5, 2, 45, 144), (5, 1, 23, 240), (3, 2, 23, 240),
                   (3, 1, 12, 480), (5, 1, 12, 480), (5, 1, 12, 672),
                   (5, 2, 12, 672), (5, 1, 6, 1152), (3, 1, 6, 1152))
# (k, stride, height, width, channels): maps smaller than the filter, odd
# and uneven sides, a channel count that leaves a part slice
RAGGED = ((3, 1, 1, 1, 4), (3, 2, 1, 2, 8), (5, 2, 2, 3, 4),
          (7, 1, 3, 1, 12), (5, 1, 7, 4, 20), (3, 2, 9, 13, 36),
          (7, 1, 13, 6, 44), (5, 2, 17, 10, 100), (3, 1, 5, 31, 68))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(n, h, w, c, k, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g)
    weight = torch.randn(c, 1, k, k, generator=g) / k
    return x, weight


def _conv2d(x, weight, stride):
    k = weight.shape[-1]
    return F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride,
                    padding=(k - 1) // 2,
                    groups=x.shape[-1]).permute(0, 2, 3, 1)


@pytest.mark.parametrize(
    "k,stride,h,w,c",
    [(k, s, side, side, c) for k, s, side, c in CONVNEXT_T + EFFICIENTNET_B0]
    + list(RAGGED))
def test_plain_version_is_conv2d(k, stride, h, w, c):
    x, weight = _inputs(2, h, w, c, k, seed=k * 1000 + h * 10 + c)
    got = depthwise.depthwise_plain(x, weight, stride)
    want = _conv2d(x, weight, stride)
    assert got.shape == want.shape == (
        2, depthwise.out_size(h, stride), depthwise.out_size(w, stride), c)
    assert got.dtype == torch.float32 and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    monkeypatch.setattr(depthwise, "launches", 0)
    x, weight = _inputs(2, 9, 9, 96, 7, seed=1)
    got = depthwise.depthwise(x, weight, 1)
    assert torch.equal(got, depthwise.depthwise_plain(x, weight, 1))
    assert depthwise.launches == 0  # the plain version counts no launch


def test_plan_picks_a_tile_of_each_instance_list():
    for (k, stride), tiles in depthwise.TILES.items():
        for side in range(1, 100):
            ho = depthwise.out_size(side, stride)
            assert depthwise.plan(k, stride, ho, ho) in tiles


def test_plan_at_convnext_tiny_and_efficientnet_b0():
    assert [depthwise.plan(k, s, depthwise.out_size(side, s),
                           depthwise.out_size(side, s))
            for k, s, side, _ in CONVNEXT_T] == [
                (5, 5), (6, 6), (6, 6), (5, 5)]
    # 5x5 at stride 2: 4x4 tiles on the 23x23 output, 3x3 on the 6x6 one
    assert [depthwise.plan(k, s, depthwise.out_size(side, s),
                           depthwise.out_size(side, s))
            for k, s, side, _ in EFFICIENTNET_B0] == [
                (6, 6), (6, 6), (6, 6), (4, 4), (6, 6), (6, 6), (6, 6),
                (6, 6), (6, 6), (3, 3), (6, 6), (6, 6)]


def _dw(c=16, k=3, stride=1, **kw):
    kw.setdefault("padding", (k - 1) // 2)
    kw.setdefault("groups", c)
    return nn.Conv2d(c, kw.pop("out", c), k, stride=stride, **kw)


class _TensorParallel(nn.Conv2d):
    """Stands in for a tensor-parallel convolution, a subclass that
    gathers its channels itself."""


@pytest.mark.parametrize("k,stride", sorted(depthwise.TILES))
@pytest.mark.parametrize("bias", [False, True])
def test_takes_the_instances(k, stride, bias):
    assert depthwise.takes(_dw(96, k, stride, bias=bias))


@pytest.mark.parametrize("conv", [
    _dw(32, 3, groups=4),  # grouped, not depthwise (RegNet)
    _dw(16, 3, out=32),  # a channel multiplier of 2
    _dw(16, 1),  # 1x1
    _dw(16, 4, padding=1),  # even
    _dw(16, 9),  # past 7
    _dw(16, 7, 2),  # 7x7 at stride 2: no instance
    _dw(16, 3, 3),  # stride 3
    _dw(16, 3, (1, 2)),  # strides that differ
    _dw(16, 3, padding=0),  # no padding
    _dw(16, 3, padding=(1, 0)),
    _dw(16, 3, dilation=2, padding=2),
    _dw(16, 3, padding_mode="reflect"),
    _dw(6, 3),  # channels not a multiple of 4
    nn.Conv2d(16, 16, (3, 5), padding=(1, 2), groups=16),  # not square
    _TensorParallel(16, 16, 3, padding=1, groups=16),
], ids=lambda conv: repr(conv))
def test_takes_nothing_else(conv):
    assert not depthwise.takes(conv)


class _OnCard:
    """A CPU tensor that says it lies on a card: the rule's other
    conditions, tried where no card is (CPU autocast stands in for the
    card's)."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def _dw_block(c=16, k=3, stride=1):
    return layers.ConvNormAct(c, c, k, stride, groups=c, act=nn.SiLU).eval()


def _nhwc_input(c=16, side=9, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, c, side, side, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)


def test_rule_takes_a_float32_channels_last_eval_input():
    block, x = _dw_block(), _OnCard(_nhwc_input())
    with torch.no_grad():
        assert layers.eval_kernel_runs(x, block)
    with torch.inference_mode():
        assert layers.eval_kernel_runs(x, block)
    block.requires_grad_(False)  # gradients on, but none to record
    assert layers.eval_kernel_runs(x, block)


def test_rule_sends_grad_bf16_autocast_nchw_and_cpu_to_cudnn():
    block, x = _dw_block(), _OnCard(_nhwc_input())
    assert torch.is_grad_enabled()
    assert not layers.eval_kernel_runs(x, block)  # parameters need grads
    block.requires_grad_(False)
    xg = _OnCard(_nhwc_input().requires_grad_(True))
    assert not layers.eval_kernel_runs(xg, block)  # the input needs one
    with torch.no_grad():
        x16 = _OnCard(_nhwc_input(dtype=torch.bfloat16))
        assert not layers.eval_kernel_runs(x16, block)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert not layers.eval_kernel_runs(x, block)
        nchw = _OnCard(x.t.contiguous())
        assert not layers.eval_kernel_runs(nchw, block)
        assert not layers.eval_kernel_runs(x.t, block)  # on the CPU


def test_convnext_shares_the_rule():
    assert convnext.eval_kernel_runs is layers.eval_kernel_runs


def _recording(monkeypatch):
    """Patch the wrapper to record each call's (k, stride, channels) and
    the rules to take CPU tensors; returns the record."""
    calls = []
    wrapper = depthwise.depthwise

    def recording(x, weight, stride):
        calls.append((weight.shape[-1], stride, x.shape[-1]))
        assert x.is_contiguous()
        return wrapper(x, weight, stride)

    monkeypatch.setattr(depthwise, "depthwise", recording)
    monkeypatch.setattr(layers, "eval_kernel_runs", lambda *a: True)
    monkeypatch.setattr(convnext, "eval_kernel_runs", lambda *a: True)
    return calls


@pytest.mark.parametrize("k,stride", sorted(depthwise.TILES))
def test_conv_norm_act_runs_the_kernel_where_it_takes_the_conv(
        monkeypatch, k, stride):
    block = _dw_block(16, k, stride)
    with torch.no_grad():
        block[1].running_mean.normal_(0, 0.1)
    x = _nhwc_input(seed=k)
    with torch.no_grad():
        want = nn.Sequential.forward(block, x)
        calls = _recording(monkeypatch)
        got = block(x)
    assert calls == [(k, stride, 16)]
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("block", [
    layers.ConvNormAct(16, 16, 3, groups=4),  # grouped, not depthwise
    layers.ConvNormAct(16, 16, 9, groups=16),  # a shape outside the list
    layers.ConvNormAct(16, 32, 1),  # a plain 1x1
], ids=["grouped", "k9", "pointwise"])
def test_conv_norm_act_keeps_cudnn_elsewhere(monkeypatch, block):
    x = _nhwc_input()
    calls = _recording(monkeypatch)
    with torch.no_grad():
        got = block.eval()(x)
        assert torch.equal(got, nn.Sequential.forward(block, x))
    assert calls == []


def test_conv_norm_act_with_a_bias_keeps_cudnn(monkeypatch):
    block = _dw_block()
    conv = block[0]
    block[0] = nn.Conv2d(16, 16, 3, padding=1, groups=16)
    block[0].weight = conv.weight
    assert depthwise.takes(block[0])  # the geometry alone would take it
    x = _nhwc_input()
    calls = _recording(monkeypatch)
    with torch.no_grad():
        assert torch.equal(block(x), nn.Sequential.forward(block, x))
    assert calls == []


def _model(name, seed=0):
    model = registry.init_weights(registry.build_model(name, 5, head=(16,)),
                                  seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):  # statistics that count
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            if isinstance(m, convnext.CNBlock):
                m.layer_scale.fill_(1.0)
    return model.eval()


# (k, stride, channels) of each depthwise call of a forward, in order
CALLS = {
    "convnext_tiny": [(7, 1, c) for c, n in zip((96, 192, 384, 768),
                                                 (3, 3, 9, 3))
                      for _ in range(n)],
    "efficientnet_b0": [(3, 1, 32), (3, 2, 96), (3, 1, 144), (5, 2, 144),
                        (5, 1, 240), (3, 2, 240), (3, 1, 480), (3, 1, 480),
                        (5, 1, 480), (5, 1, 672), (5, 1, 672), (5, 2, 672),
                        (5, 1, 1152), (5, 1, 1152), (5, 1, 1152),
                        (3, 1, 1152)],
}


@pytest.mark.parametrize("name,count", [("convnext_tiny", 18),
                                        ("efficientnet_b0", 16)])
def test_call_sites_through_the_plain_version_match_aten(monkeypatch, name,
                                                         count):
    """The kernel path's wiring on the CPU: with the rule forced on, every
    depthwise convolution goes through the wrapper (its plain version
    here) on its NHWC view; the logits match ATen's path."""
    model = _model(name).to(memory_format=torch.channels_last)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = model(x)
        calls = _recording(monkeypatch)
        got = model(x)
    assert len(calls) == count and calls == CALLS[name]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["efficientnet_b0", "mobilenet_v3_small"])
@pytest.mark.parametrize("fmt", [torch.contiguous_format,
                                 torch.channels_last])
def test_cpu_eval_forward_is_bit_equal_to_aten(monkeypatch, name, fmt):
    model = _model(name).to(memory_format=fmt)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    x = x.contiguous(memory_format=fmt)
    with torch.no_grad():
        got = model(x)
        with monkeypatch.context() as mp:
            # the forward ConvNormAct had before the kernel path existed
            mp.setattr(layers.ConvNormAct, "forward", nn.Sequential.forward)
            want = model(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["efficientnet_b0", "mobilenet_v3_large",
                                  "efficientnet_v2_s"])
def test_state_dict_keys_unchanged(name):
    model = registry.build_model(name, 5)
    keys = list(model.state_dict())
    plain = registry.build_model(name, 5)
    for parent in list(plain.modules()):
        for child_name, child in parent.named_children():
            if isinstance(child, layers.ConvNormAct):
                setattr(parent, child_name, nn.Sequential(*child))
    assert not any(isinstance(m, layers.ConvNormAct)
                   for m in plain.modules())
    assert keys == list(plain.state_dict())
