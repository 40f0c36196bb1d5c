"""ConvNeXt's eval LayerNorm kernel (``sykepic_tpu_torch/ops/layernorm.py``,
``csrc/layernorm.cu``) on the CPU: its plain version against
``F.layer_norm`` of ``x + pre_bias`` at every ConvNeXt width, the wrapper's
CPU path, the launch plan, the rule that picks the kernel in the model,
ConvNeXt-T's call sites run through the plain version, and the CPU forward
unchanged bit for bit. The kernel itself runs only on the card
(``tests/test_torch_gpu.py``).

Tolerance of the plain version against ``F.layer_norm``: 1e-5 absolute on
outputs below 8, for float32 sums taken in another order (ATen's Welford
pass against two passes of plain sums)."""

import pytest
import torch
from torch import nn
from torch.nn import functional as F

from sykepic_tpu_torch.models import convnext, registry
from sykepic_tpu_torch.ops import layernorm

WIDTHS = (96, 192, 384, 768, 1536)  # ConvNeXt-T/S, and ConvNeXt-L's widest
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(rows_shape, c, seed):
    g = torch.Generator().manual_seed(seed)
    x = 2 * torch.randn(*rows_shape, c, generator=g) + 0.5
    w = 1 + 0.1 * torch.randn(c, generator=g)
    b = 0.1 * torch.randn(c, generator=g)
    pb = 0.5 * torch.randn(c, generator=g)
    return x, w, b, pb


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("rows_shape", [(37,), (3, 5, 7), (1,)])
def test_plain_version_is_layer_norm_of_the_sum(c, pre, rows_shape):
    x, w, b, pb = _inputs(rows_shape, c, seed=c)
    pb = pb if pre else None
    got = layernorm.layernorm_plain(x, w, b, convnext.LN_EPS, pre_bias=pb)
    want = F.layer_norm(x if pb is None else x + pb, (c,), w, b,
                        convnext.LN_EPS)
    assert got.shape == x.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    monkeypatch.setattr(layernorm, "launches", 0)
    x, w, b, pb = _inputs((2, 9, 9), 96, seed=1)
    got = layernorm.layernorm(x, w, b, 1e-6, pre_bias=pb)
    assert torch.equal(got, layernorm.layernorm_plain(x, w, b, 1e-6,
                                                      pre_bias=pb))
    assert layernorm.launches == 0  # the plain version counts no launch


def test_plan_covers_every_width():
    for c in range(4, layernorm.MAX_CHANNELS + 1, 4):
        lanes, per_lane = layernorm.plan(c)
        assert lanes in (1, 2, 4, 8, 16, 32) and 1 <= per_lane <= 12, c
        assert lanes * per_lane * 4 >= c
        # the fewest lanes that leave a lane at most four float4
        assert per_lane <= 4 or lanes == 32
        assert lanes == 1 or -(-c // (4 * (lanes // 2))) > 4


def test_plan_at_convnext_tiny_widths():
    assert [layernorm.plan(c) for c in (96, 192, 384, 768)] == [
        (8, 3), (16, 3), (32, 3), (32, 6)]


class _OnCard:
    """A CPU tensor that says it lies on a card: the rule's other
    conditions, tried where no card is (CPU autocast stands in for the
    card's)."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def _block_and_input(dtype=torch.float32, requires_grad=False):
    block = convnext.CNBlock(96, 0.0).eval()
    x = torch.randn(2, 96, 8, 8).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return block, _OnCard(x.requires_grad_(requires_grad))


def test_rule_takes_a_float32_channels_last_eval_input():
    block, x = _block_and_input()
    with torch.no_grad():
        assert convnext.eval_kernel_runs(x, block)
    with torch.inference_mode():
        assert convnext.eval_kernel_runs(x, block)
    # gradients on, but nothing requires one: nothing is recorded
    block.requires_grad_(False)
    assert convnext.eval_kernel_runs(x, block)


def test_rule_sends_grad_bf16_autocast_nchw_and_cpu_to_aten():
    block, x = _block_and_input()
    assert torch.is_grad_enabled()
    assert not convnext.eval_kernel_runs(x, block)  # parameters need grads
    block.requires_grad_(False)
    _, xg = _block_and_input(requires_grad=True)
    assert not convnext.eval_kernel_runs(xg, block)  # the input needs one
    with torch.no_grad():
        _, x16 = _block_and_input(torch.bfloat16)
        assert not convnext.eval_kernel_runs(x16, block)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert not convnext.eval_kernel_runs(x, block)
        nchw = _OnCard(x.t.contiguous())
        assert not convnext.eval_kernel_runs(nchw, block)
        assert not convnext.eval_kernel_runs(x.t, block)  # on the CPU


def _tiny_model(seed=0):
    model = registry.init_weights(
        registry.build_model("convnext_tiny", 5, head=(16,)), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            # non-zero biases, scales and shifts, so that a bias dropped or
            # added twice shows
            if isinstance(m, (nn.Conv2d, nn.Linear, nn.LayerNorm)):
                m.bias.normal_(0, 0.2, generator=g)
            if isinstance(m, nn.LayerNorm):
                m.weight.normal_(1, 0.2, generator=g)
            if isinstance(m, convnext.CNBlock):
                m.layer_scale.fill_(1.0)
    return model.eval()


def test_call_sites_through_the_plain_version_match_aten(monkeypatch):
    """The kernel path's wiring on the CPU: with the rule forced on, every
    LayerNorm goes through the wrapper (its plain version here), the stem's
    and each block's convolution without its bias and the bias as
    ``pre_bias``; the logits match ATen's path."""
    model = _tiny_model()
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    x = x.contiguous(memory_format=torch.channels_last)
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        want = model(x)
    calls = []
    wrapper = layernorm.layernorm

    def recording(h, weight, bias, eps, pre_bias=None):
        calls.append((h.shape[-1], pre_bias is not None, h.is_contiguous()))
        return wrapper(h, weight, bias, eps, pre_bias=pre_bias)

    monkeypatch.setattr(layernorm, "layernorm", recording)
    monkeypatch.setattr(convnext, "eval_kernel_runs", lambda *a: True)
    with torch.no_grad():
        got = model(x)
    # stem (pre_bias), 18 blocks (pre_bias), 3 downsamples (none)
    assert len(calls) == 22
    assert sum(pre for _, pre, _ in calls) == 19
    assert all(contiguous for _, _, contiguous in calls)
    assert [c for c, pre, _ in calls if not pre] == [96, 192, 384]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _pre_change_forwards(monkeypatch):
    """The forwards the model had before the kernel path existed."""
    def ln2d(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.permute(0, 3, 1, 2)

    def block(self, x):
        return x + self.stochastic_depth(self.layer_scale * self.block(x))

    monkeypatch.setattr(convnext.LayerNorm2d, "forward", ln2d)
    monkeypatch.setattr(convnext.CNBlock, "forward", block)
    monkeypatch.setattr(convnext.Stem, "forward", nn.Sequential.forward)


@pytest.mark.parametrize("fmt", [torch.contiguous_format,
                                 torch.channels_last])
def test_cpu_eval_forward_is_bit_equal_to_aten(monkeypatch, fmt):
    model = _tiny_model().to(memory_format=fmt)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    x = x.contiguous(memory_format=fmt)
    with torch.no_grad():
        got = model(x)
        with monkeypatch.context() as mp:
            _pre_change_forwards(mp)
            want = model(x)
    assert torch.equal(got, want)


def test_state_dict_keys_unchanged():
    model = _tiny_model()
    keys = list(model.state_dict())
    assert keys[:4] == ["features.0.0.weight", "features.0.0.bias",
                        "features.0.1.weight", "features.0.1.bias"]
    plain = _tiny_model()
    stem = plain.features[0]
    plain.features[0] = nn.Sequential(stem[0], stem[1])
    assert keys == list(plain.state_dict())
    assert isinstance(model.features[0], nn.Sequential)
