"""Swin's window-attention kernel (``sykepic_tpu_torch/ops/
window_attention.py``, ``csrc/window_attention.cu``) on the CPU: its plain
version, which reads q, k and v from the unpadded map, against
``ShiftedWindowAttention``'s SDPA path over padded, rolled windows; the
padded keys' semantics; the block plan; the rule that sends a forward to
the kernel; and a whole Swin's forward through the plain version. The kernel
itself runs only on the card (``tests/test_torch_gpu.py``).

Shapes: the station's stage maps at 180 px (45/23/12/6, padded to
49/28/14/7) at Swin-T's widths and heads and at Swin-B's, each with and
without the shift (stage 4's 6x6 pads to one window, so the rule drops its
shift), and odd and tiny maps (one token; a map that is one window; a
window along one axis only, so one shift is dropped and the other kept).

``TOL``: ``proj`` of the plain version's output within 1e-5 of its spread
of the SDPA path's, float32 with the sums in another order (explicit
products against SDPA's, the mask added to the scores in another order);
1e-6 to 2e-6 of the spread seen. Padded keys with zero k and v instead of
``qkv``'s bias (the k and v of a zero token) move the result by 0.6 to 1.9
of the spread wherever they are not masked off, so the comparison cannot
pass with padded keys other than torchvision's.
"""

from __future__ import annotations

import pytest
import torch
from torch import nn
from torch.nn import functional as F

from sykepic_tpu_torch.models import layers, swin
from sykepic_tpu_torch.ops import window_attention as wa

TOL = 1e-5

# (height, width, channels, heads) of a 180-px ROI's four stages
SWIN_T = ((45, 45, 96, 3), (23, 23, 192, 6), (12, 12, 384, 12),
          (6, 6, 768, 24))
SWIN_B = ((45, 45, 128, 4), (23, 23, 256, 8), (12, 12, 512, 16),
          (6, 6, 1024, 32))
ODD = ((1, 1, 32, 1), (7, 7, 32, 1), (8, 13, 64, 2), (3, 20, 96, 3),
       (14, 9, 64, 2), (30, 5, 64, 2))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _attention(c: int, heads: int, shift: int, seed: int):
    """A ``ShiftedWindowAttention`` with weights of unit-variance outputs,
    biases and a bias table of order 1, as trained ones are."""
    g = torch.Generator().manual_seed(seed)
    m = swin.ShiftedWindowAttention(c, swin.WINDOW, shift, heads)
    with torch.no_grad():
        for name, p in m.named_parameters():
            scale = {"qkv.weight": c ** -0.5, "proj.weight": c ** -0.5,
                     "relative_position_bias_table": 1.0}.get(name, 0.5)
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return m.eval()


def _map(h: int, w: int, c: int, seed: int = 1):
    return torch.randn(2, h, w, c, generator=torch.Generator().manual_seed(
        seed))


def _shifts(m, h: int, w: int) -> tuple[int, int]:
    return m.shifts(-(-h // swin.WINDOW) * swin.WINDOW,
                    -(-w // swin.WINDOW) * swin.WINDOW)


def _plain(m, x, qkv_bias=None):
    """``proj`` of the plain version on ``qkv`` of the unpadded map."""
    qkv = F.linear(x, m.qkv.weight, m.qkv.bias)
    y = wa.window_attention_plain(
        qkv, m.qkv.bias if qkv_bias is None else qkv_bias,
        m.relative_position_bias_table, m.num_heads, _shifts(m, *x.shape[1:3]))
    return m.proj(y)


def _gap(got, want) -> float:
    return float((got - want).abs().max()) / float(want.std())


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("h,w,c,heads", SWIN_T + SWIN_B + ODD)
def test_plain_version_matches_the_sdpa_path(h, w, c, heads, shift):
    m = _attention(c, heads, shift, h * 100 + w + shift)
    x = _map(h, w, c)
    with torch.no_grad():
        want = m(x)
        got = _plain(m, x)
    assert got.shape == want.shape and got.is_contiguous()
    assert _gap(got, want) <= TOL


def test_the_shift_is_dropped_where_the_window_covers_the_axis():
    """Stage 4's 6x6 map pads to one window: no shift either way; a 3x20
    map keeps the shift along its width only."""
    m = _attention(96, 3, 3, 0)
    assert _shifts(m, 6, 6) == (0, 0)
    assert _shifts(m, 3, 20) == (0, 3)
    assert _shifts(m, 45, 45) == (3, 3)


# maps whose padded keys the region mask does not take out: the unshifted
# stage maps, and shifted ones whose padding is not one whole region
PADDED_KEYS_COUNT = [(h, w, c, heads, 0) for h, w, c, heads in SWIN_T] + [
    (23, 23, 192, 6, 3), (12, 12, 384, 12, 3), (8, 13, 64, 2, 3)]


@pytest.mark.parametrize("zeroed", ["k", "v", "kv"])
@pytest.mark.parametrize("h,w,c,heads,shift", PADDED_KEYS_COUNT)
def test_padded_keys_of_zero_k_or_v_fail_the_tolerance(h, w, c, heads, shift,
                                                        zeroed):
    m = _attention(c, heads, shift, h * 100 + w + shift)
    x = _map(h, w, c)
    bias = m.qkv.bias.detach().clone()
    if "k" in zeroed:
        bias[c:2 * c] = 0
    if "v" in zeroed:
        bias[2 * c:] = 0
    with torch.no_grad():
        want = m(x)
        wrong = _plain(m, x, bias)
    assert _gap(wrong, want) > 10 * TOL


@pytest.mark.parametrize("heads,group", [
    (3, 3), (6, 3), (12, 3), (24, 3), (4, 1), (8, 1), (16, 1), (32, 1),
    (1, 1), (2, 1), (5, 1), (10, 1), (18, 3)])
def test_plan_takes_three_heads_a_block_where_three_divide(heads, group):
    assert wa.plan(heads) == group


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    m = _attention(64, 2, 3, 5)
    x = _map(8, 13, 64)
    qkv = F.linear(x, m.qkv.weight, m.qkv.bias).detach()
    args = (qkv, m.qkv.bias.detach(), m.relative_position_bias_table.detach(),
            2, (3, 3))
    n0 = wa.launches
    assert torch.equal(wa.window_attention(*args),
                       wa.window_attention_plain(*args))
    assert wa.launches == n0  # plain calls are not launches


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

class _OnCard:
    """A CPU tensor that says it lies on a card: the rule's other
    conditions, tried where no card is (CPU autocast stands in for the
    card's)."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def _recording(monkeypatch, on_card: bool):
    """Patch the wrapper and its plain version to record their calls;
    with ``on_card`` the eval rule judges the input as if it lay on a
    card, so the CPU forward reaches the wrapper (and its plain version)
    wherever the rule would send a card's. Returns the record."""
    calls = []
    wrapper, plain = wa.window_attention, wa.window_attention_plain

    def recording(name, fn):
        def call(*args):
            calls.append(name)
            return fn(*args)
        return call

    monkeypatch.setattr(wa, "window_attention",
                        recording("kernel", wrapper))
    monkeypatch.setattr(wa, "window_attention_plain",
                        recording("plain", plain))
    if on_card:
        monkeypatch.setattr(swin, "eval_kernel_runs",
                            lambda x, m: layers.eval_kernel_runs(
                                _OnCard(x), m))
    return calls


@pytest.mark.parametrize("on_card", [False, True])
def test_eval_forward_takes_the_kernel_only_on_the_card(monkeypatch,
                                                        on_card):
    m = _attention(96, 3, 3, 7)
    x = _map(23, 23, 96)
    with torch.no_grad():
        want = m(x)
        calls = _recording(monkeypatch, on_card)
        got = m(x)
    # on the card the wrapper launches the kernel; here it runs its plain
    # version
    assert calls == (["kernel", "plain"] if on_card else [])
    assert _gap(got, want) <= TOL


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("mode", ["train", "grad", "bf16", "autocast"])
def test_training_bf16_and_autocast_keep_sdpa(monkeypatch, on_card, mode):
    m = _attention(64, 2, 3, 8)
    x = _map(9, 9, 64)
    calls = _recording(monkeypatch, on_card)
    if mode == "train":
        m.train()(x).sum().backward()
        assert m.qkv.weight.grad is not None
    elif mode == "grad":  # eval mode, gradients recorded
        m(x)
    elif mode == "bf16":
        with torch.no_grad():
            m.to(torch.bfloat16)(x.to(torch.bfloat16))
    else:
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            m(x)
    assert calls == []


class _Sharded(nn.Linear):
    """Stands in for a tensor-parallel ``qkv`` (``parallel.ColumnParallel``
    wraps it): any module that is not exactly ``nn.Linear``."""


@pytest.mark.parametrize("case", ["sharded_qkv", "sharded_proj", "window_5",
                                  "head_dim_16"])
def test_other_modules_keep_sdpa(monkeypatch, case):
    c, heads, window = (32, 2, 7) if case == "head_dim_16" else (64, 2, 7)
    if case == "window_5":
        window = 5
    m = swin.ShiftedWindowAttention(c, window, window // 2, heads).eval()
    if case == "sharded_qkv":
        m.qkv = _Sharded(c, 3 * c)
    elif case == "sharded_proj":
        m.proj = _Sharded(c, c)
    calls = _recording(monkeypatch, on_card=True)
    with torch.no_grad():
        m(_map(9, 9, c))
    assert calls == []


def test_the_rule_takes_swin_t_s_and_b(monkeypatch):
    """Every attention of Swin-T, -S and -B has head dim 32 and window 7:
    the rule takes each on the card."""
    from sykepic_tpu_torch.models import registry

    monkeypatch.setattr(swin, "eval_kernel_runs", lambda *a: True)
    for name in ("swin_t", "swin_s", "swin_b"):
        with torch.device("meta"):
            model = registry.build_model(name, 50)
        blocks = [m for m in model.modules()
                  if isinstance(m, swin.ShiftedWindowAttention)]
        assert len(blocks) == sum(swin.SWIN_CFGS[name][1])
        for m in blocks:
            x = torch.empty(1, 7, 7, m.qkv.in_features, device="meta")
            assert m.kernel_runs(x)


# ---------------------------------------------------------------------------
# a whole Swin through the plain version
# ---------------------------------------------------------------------------

def _swin_32(seed: int = 0):
    """A small Swin of head dim 32 (C 32, heads 1/2/4/8, depths 2/2/2/2)
    with weights of order 1 in every attention."""
    model = swin.SwinTransformer(32, (2, 2, 2, 2), (1, 2, 4, 8), 0.0, 10,
                                 head=(16,))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return model.eval().to(memory_format=torch.channels_last)


@pytest.mark.parametrize("size", [60, 100])
def test_swin_forward_through_the_plain_version(monkeypatch, size):
    """60 px: maps 15/8/4/2, 100 px: 25/13/7/4; padded windows, shifts
    kept and dropped. Eight attentions a forward reach the wrapper; the
    logits match the SDPA path's."""
    model = _swin_32(size)
    x = torch.rand(4, 3, size, size, generator=torch.Generator().manual_seed(
        size)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = model(x)
        calls = _recording(monkeypatch, on_card=True)
        got = model(x)
    assert calls.count("kernel") == calls.count("plain") == 8
    assert _gap(got, want) <= TOL
