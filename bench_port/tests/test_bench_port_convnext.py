"""ConvNeXt-T's cell and the staged small-samples cell on the CPU: both tiny
cells correct; the port's ConvNeXt-T against the plain reference on seeded
weights; faults planted in the port's blocks failing the tiny cell's check;
the seeded ``layer_scale`` keeping every stage in the result; and the
yardstick of LayerNorm and GELU bytes with its two readers."""

from __future__ import annotations

import pytest
import torch

from bench_port import flops, gen, harness
from bench_port.norm_bytes import forward_norm_bytes
from bench_port.reference import prob as ref_prob
from bench_port.reference.nets import convnext_tiny as ref_net
from bench_port.reference.nets import resnet18 as ref_resnet18
from bench_port.tests.tiny import ROOT, SEED, run_tiny, staged_bench, tiny_plan

CELL = "convnext_tiny.prob.archive"
# staged, not in BENCHMARK.json: its rate spread more than 3% over six runs
# on the card
SMALL = {"name": "resnet18.prob.small_samples", "config": "resnet18",
         "traffic": "prob_small_samples", "chips": 1}
CFG = {"image_shape": [3, 180, 180], "head": [256, 128], "num_classes": 50}
H100 = "NVIDIA H100 80GB HBM3"
LN_KERNEL = ("void at::native::(anonymous namespace)::"
             "vectorized_layer_norm_kernel<float, float>(int, float, "
             "float const*, float const*, float const*, float*, float*, "
             "float*)")
GELU_KERNEL = ("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, "
               "at::native::GeluType)::{lambda()#2}::operator()() const")


def _bench() -> dict:
    """``staged_bench()`` with the small-samples cell staged too."""
    bench = staged_bench()
    bench["workloads"].append(SMALL)
    next(m for m in bench["end_to_end"]
         if m["name"] == "rois_per_s")["workloads"].append(SMALL["name"])
    return bench


@pytest.mark.parametrize("cell", [CELL, SMALL["name"]])
def test_tiny_cell_is_correct(cell):
    result = run_tiny(tiny_plan(cell, _bench()))
    assert result["correct"], result["checks"]


def test_port_logits_match_reference():
    """At 64x64, the port's ``convnext_tiny`` loading the reference's
    ``best_state.pth`` (strict), in channels_last as the engine runs it,
    gives the reference's logits within 1e-5 of their spread."""
    from sykepic_tpu_torch.models import registry

    cfg = dict(tiny_plan(CELL)["cfg"], image_shape=[3, 64, 64])
    params = gen.make_weights(ref_net, cfg, SEED, torch.device("cpu"),
                              gen.fixture_images())
    model = registry.build_model("convnext_tiny", cfg["num_classes"],
                                 head=cfg["head"])
    model.load_state_dict(params, strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    x = torch.rand((8, 3, 64, 64), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = ref_net.forward(params, x, cfg)
        got = model(x.contiguous(memory_format=torch.channels_last))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.std())


def _plant(monkeypatch, spoil):
    """``spoil(model)`` on every ConvNeXt the port builds."""
    from sykepic_tpu_torch.models import convnext

    real = convnext.ConvNeXt.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        spoil(self)

    monkeypatch.setattr(convnext.ConvNeXt, "__init__", init)


def _branch_dropped(model):
    """The fifth block of stage 3 returns its input: its ``layer_scale``
    branch is gone."""
    model.features[5][4].forward = lambda x: x


def _norm_skipped(model):
    """The fifth block of stage 3 skips its LayerNorm."""
    model.features[5][4].block[2].forward = lambda x: x


@pytest.mark.parametrize("spoil", [_branch_dropped, _norm_skipped])
def test_planted_faults_fail(spoil, monkeypatch):
    _plant(monkeypatch, spoil)
    result = run_tiny(tiny_plan(CELL))
    assert not result["correct"], result["checks"]
    assert (result["checks"]["max_abs_dp"]["value"]
            > 10 * result["checks"]["max_abs_dp"]["limit"])


@pytest.mark.parametrize("stage", range(len(ref_net.DIMS)))
def test_every_stage_counts(stage, tmp_path):
    """Zeroing one stage's ``layer_scale`` in the seeded weights moves the
    tiny cell's probabilities by more than ten times the cell's limit."""
    plan = tiny_plan(CELL)
    cfg = plan["cfg"]
    pool = gen.build_pool(tmp_path, plan["traffic"]["pool"], SEED)
    rois = [img for _, img in gen.ref_ifcb.read_sample(pool[0]["path"])]
    cpu = torch.device("cpu")
    params = gen.make_weights(ref_net, cfg, SEED, cpu, rois)
    zeroed = {k: torch.zeros_like(v)
              if k.startswith(f"features.{2 * stage + 1}.")
              and k.endswith(".layer_scale") else v
              for k, v in params.items()}
    assert sum(k.endswith(".layer_scale") and v.abs().sum() == 0
               for k, v in zeroed.items()) == ref_net.DEPTHS[stage]
    base = ref_prob.probabilities(rois, params, ref_net, cfg, cpu)
    moved = ref_prob.probabilities(rois, zeroed, ref_net, cfg, cpu)
    limit = plan["limits"]["max_abs_dp"]["limit"]
    assert abs(moved - base).max() > 10 * limit


@pytest.mark.parametrize("net,layer_norm,gelu", [
    # 1,865,952 LayerNorm and 5,351,040 GELU elements, read and written once
    # at 4 bytes
    (ref_net, (22, 14_927_616), (18, 42_808_320)),
    (ref_resnet18, (0, 0), (0, 0))])
def test_norm_bytes_by_hand(net, layer_norm, gelu):
    counts = forward_norm_bytes(net, CFG)
    assert (counts["layer_norm"]["calls"],
            counts["layer_norm"]["bytes"]) == layer_norm
    assert (counts["gelu"]["calls"], counts["gelu"]["bytes"]) == gelu


def test_forward_flops():
    assert flops.forward_flops(ref_net, CFG) / 1e9 == pytest.approx(
        5.381, abs=5e-4)


def _reader(name):
    return harness.load_module(ROOT / "bench_port" / "metrics" / f"{name}.py")


K1_KERNEL = "void (anonymous namespace)::resize_pad_kernel<float, 3, 0>(Params)"
DISPATCHES = 50
# reader -> (its kernel, bytes a ROI, launches of the window it reads:
# one a call for LayerNorm, twice that in its two-kernel form; for GELU
# one a call, and more where ATen splits a call of more than 2**31 bytes)
READERS = {
    "layernorm_roofline.rois": (LN_KERNEL, 14_927_616,
                                (22 * DISPATCHES, 44 * DISPATCHES)),
    "gelu_roofline.rois": (GELU_KERNEL, 42_808_320,
                           (18 * DISPATCHES, 18 * DISPATCHES + 447))}
# reader -> launches that silence it: not a whole multiple of the forward's
# 22 LayerNorms; fewer than the forward's 18 GELUs a dispatch
TOO_FEW = {"layernorm_roofline.rois": 22 * DISPATCHES + 1,
           "gelu_roofline.rois": 18 * DISPATCHES - 1}


def _ctx(kernels, platform="gpu"):
    return {"cfg": CFG,
            "tallies": {"net": ref_net, "rois": 20000, "window_s": 5.0,
                        "dtype": "float32", "stages": {}},
            "device": {"platform": platform,
                       "kind": H100 if platform == "gpu" else "cpu",
                       "busy_s": 4.5, "window_s": 5.0},
            "trace": {"kernels": {"sm90_xmma_gemm_f32f32": [3.0, 900],
                                  K1_KERNEL: [0.01, DISPATCHES],
                                  **kernels}}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_roofline_reader_on_canned_numbers(name):
    kernel, per_roi, counts = READERS[name]
    for launches in counts:
        ctx = _ctx({kernel: [0.25, launches]})
        assert _reader(name).read(ctx) == pytest.approx(
            100 * per_roi * 20000 / 3.35e12 / 0.25)


@pytest.mark.parametrize("case", ["no_kernels", "no_card", "too_few",
                                  "other_network"])
@pytest.mark.parametrize("name", sorted(READERS))
def test_roofline_reader_is_silent(name, case):
    kernel, _, (launches, _) = READERS[name]
    ctx = {"no_kernels": _ctx({}),
           "no_card": _ctx({}, platform="cpu"),
           "too_few": _ctx({kernel: [0.25, TOO_FEW[name]]}),
           "other_network": _ctx({kernel: [0.25, launches]})}[case]
    if case == "other_network":
        ctx["tallies"]["net"] = ref_resnet18
    assert _reader(name).read(ctx) is None


def test_gelu_reader_needs_the_dispatch_count():
    kernel, _, (launches, _) = READERS["gelu_roofline.rois"]
    ctx = _ctx({kernel: [0.25, launches]})
    del ctx["trace"]["kernels"][K1_KERNEL]
    assert _reader("gelu_roofline.rois").read(ctx) is None
