"""Swin-T's cell on the CPU: the tiny cell correct; the port's Swin-T loading
the reference's seeded weights against the plain reference; faults planted
in the port's attention failing the tiny cell's check; the yardstick of the
attention's bytes and FLOPs by hand; and both new readers on canned
numbers, silent without their names."""

from __future__ import annotations

import pytest
import torch

from bench_port import flops, gen, harness
from bench_port.attention_bytes import forward_attention_work
from bench_port.norm_bytes import forward_norm_bytes
from bench_port.reference.nets import convnext_tiny as ref_convnext
from bench_port.reference.nets import swin_t as ref_net
from bench_port.tests.tiny import ROOT, SEED, run_tiny, tiny_plan

CELL = "swin_t.prob.archive"
CFG = {"image_shape": [3, 180, 180], "head": [256, 128], "num_classes": 50}
H100 = "NVIDIA H100 80GB HBM3"
FMHA_KERNEL = ("fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention"
               "::AttentionKernel<float, cutlass::arch::Sm80, true, 64, 64, "
               "64, true, true>::Params)")
# q, k, v read and the output written once, 4 bytes a value, over each
# block's windows x heads x 49 tokens x 32 channels; the two products 4 N^2 d
# FLOPs a window and head. Stage 1 at 180 px: 2 blocks x 49 windows x 3 heads
STAGE1 = {"calls": 2, "bytes": 2 * 49 * 3 * 49 * 32 * 4 * 4,
          "flops": 2 * 49 * 3 * 4 * 49 * 49 * 32}
WHOLE = {"calls": 12, "bytes": 20_622_336, "flops": 252_623_616}


def test_tiny_cell_is_correct():
    result = run_tiny(tiny_plan(CELL))
    assert result["correct"], result["checks"]


def test_port_logits_match_reference():
    """At 64x64, the port's ``swin_t`` loading the reference's
    ``best_state.pth`` (strict, index buffers computed by the loader), in
    channels_last as the engine runs it, gives the reference's logits
    within 2e-5 of their spread."""
    from sykepic_tpu_torch.models import checkpoint, registry

    cfg = dict(tiny_plan(CELL)["cfg"], image_shape=[3, 64, 64])
    params = gen.make_weights(ref_net, cfg, SEED, torch.device("cpu"),
                              gen.fixture_images())
    model = registry.build_model("swin_t", cfg["num_classes"],
                                 head=cfg["head"])
    model.load_state_dict(checkpoint.normalize_state_dict(params, "swin_t"),
                          strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    x = torch.rand((8, 3, 64, 64), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = ref_net.forward(params, x, cfg)
        got = model(x.contiguous(memory_format=torch.channels_last))
    assert float((got - want).abs().max()) <= 2e-5 * float(want.std())


def _unshifted(attn):
    """Every block's windows unshifted: no roll, no region mask."""
    attn.shift = 0


def _no_bias(attn):
    """The relative-position bias left out of the scores, the region mask
    (-100 plus a bias of order 1) kept."""
    real = attn.attn_mask

    def attn_mask(pad_h, pad_w, ref):
        mask = real(pad_h, pad_w, ref)
        return torch.where(mask <= -50, mask, torch.zeros_like(mask))

    attn.attn_mask = attn_mask


@pytest.mark.parametrize("spoil", [_unshifted, _no_bias])
def test_planted_faults_fail(spoil, monkeypatch):
    from sykepic_tpu_torch.models import swin

    real = swin.SwinTransformer.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        for m in self.modules():
            if isinstance(m, swin.ShiftedWindowAttention):
                spoil(m)

    monkeypatch.setattr(swin.SwinTransformer, "__init__", init)
    result = run_tiny(tiny_plan(CELL))
    assert not result["correct"], result["checks"]
    assert (result["checks"]["max_abs_dp"]["value"]
            > 10 * result["checks"]["max_abs_dp"]["limit"])


def test_attention_work_by_hand():
    stage1 = dict(CFG, swin={"depths": [2], "heads": [3]})
    assert forward_attention_work(ref_net, stage1) == STAGE1
    assert forward_attention_work(ref_net, CFG) == WHOLE
    assert forward_attention_work(ref_convnext, CFG) == {
        "calls": 0, "bytes": 0, "flops": 0}


def test_forward_flops_and_norm_bytes():
    assert flops.forward_flops(ref_net, CFG) / 1e9 == pytest.approx(
        7.125, abs=5e-4)
    # 2,549,088 LayerNorm and 3,916,032 GELU elements, read and written once
    # at 4 bytes
    counts = forward_norm_bytes(ref_net, CFG)
    assert counts["layer_norm"] == {"calls": 29, "bytes": 20_392_704}
    assert counts["gelu"] == {"calls": 12, "bytes": 31_328_256}


def _reader(name):
    return harness.load_module(ROOT / "bench_port" / "metrics" / f"{name}.py")


DISPATCHES = 50


def _ctx(kernels, platform="gpu", stages=None, net=ref_net):
    return {"cfg": CFG,
            "tallies": {"net": net, "rois": 20000, "window_s": 5.0,
                        "dtype": "float32", "stages": stages or {}},
            "device": {"platform": platform,
                       "kind": H100 if platform == "gpu" else "cpu",
                       "busy_s": 4.5, "window_s": 5.0},
            "trace": {"kernels": {"sm90_xmma_gemm_f32f32": [3.0, 900],
                                  **kernels}}}


def test_attention_roofline_on_canned_numbers():
    ctx = _ctx({FMHA_KERNEL: [0.25, 12 * DISPATCHES]})
    # bytes bound it: 6.16 us a ROI against 3.77 us of FLOPs
    least = 20000 * max(WHOLE["bytes"] / 3.35e12, WHOLE["flops"] / 67e12)
    assert least == 20000 * WHOLE["bytes"] / 3.35e12
    assert _reader("attention_roofline.rois").read(ctx) == pytest.approx(
        100 * least / 0.25)


@pytest.mark.parametrize("case", ["no_kernels", "no_card", "not_whole",
                                  "other_network"])
def test_attention_roofline_is_silent(case):
    ctx = {"no_kernels": _ctx({}),
           "no_card": _ctx({}, platform="cpu"),
           "not_whole": _ctx({FMHA_KERNEL: [0.25, 12 * DISPATCHES + 1]}),
           "other_network": _ctx({FMHA_KERNEL: [0.25, 12 * DISPATCHES]},
                                 net=ref_convnext)}[case]
    assert _reader("attention_roofline.rois").read(ctx) is None


def test_attention_pad_pct_on_canned_numbers():
    ctx = _ctx({}, stages={"swin.tokens": 7644 * 2048,
                           "swin.pad_tokens": 1600 * 2048,
                           "engine.slots": 2048})
    assert _reader("attention_pad_pct.rois").read(ctx) == pytest.approx(
        100 * 1600 / 7644)
    # a program that counts no windows, as the parent does
    assert _reader("attention_pad_pct.rois").read(
        _ctx({}, stages={"engine.slots": 2048})) is None


def test_tiny_traced_run_reads_the_pad_share():
    """32 px: maps 8/4/2/1 padded to 14/7/7/7, 696 of 882 query tokens a
    slot padding."""
    result = run_tiny(tiny_plan(CELL), trace=True)
    assert result["correct"]
    assert result["metrics"]["attention_pad_pct.rois"]["value"] == \
        pytest.approx(100 * 696 / 882)
