"""The yardstick's arithmetic: FLOPs, K1's bytes, the trace reduction and
each per-layer reader on canned numbers."""

from __future__ import annotations

import importlib

import pytest

from bench_port import flops, harness, tracing

from bench_port.tests.tiny import ROOT

BENCH = harness.read_json(ROOT / harness.BENCHMARK)
CFG = {"image_shape": [3, 180, 180], "head": [256, 128], "num_classes": 50}


@pytest.mark.parametrize("network,gflop", [("resnet18", 2.513),
                                           ("efficientnet_b0", 0.547)])
def test_forward_flops(network, gflop):
    net = importlib.import_module(f"bench_port.reference.nets.{network}")
    assert flops.forward_flops(net, CFG) / 1e9 == pytest.approx(gflop,
                                                                abs=5e-4)


def test_k1_bytes_by_hand():
    # two ROIs of 30x50 and 100x60 pixels into 180x180x3 float32 slots:
    # 1500 + 6000 pixels read, 2 x 388800 bytes written, 2 x 40 of metadata
    assert flops.k1_eval_bytes(7500, 2, 180, 3, "float32") == (
        7500 + 2 * 180 * 180 * 3 * 4 + 2 * 40)
    # bfloat16 slots, and the train form's 20 bytes of affine rows and
    # brightness a slot
    assert flops.k1_train_bytes(7500, 2, 180, 3, "bfloat16") == (
        7500 + 2 * 180 * 180 * 3 * 2 + 2 * 40 + 2 * 20)


def test_peaks_table():
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    assert peak["flops_per_s"]["float32"] == 67e12
    assert peak["flops_per_s"]["bfloat16"] == 989e12
    assert peak["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        flops.peaks("cpu")


def test_trace_reduction():
    ms = 1_000_000
    device = [("resize_pad_kernel", 0, 2 * ms), ("conv", 1 * ms, 5 * ms),
              ("conv", 8 * ms, 9 * ms), ("late", 12 * ms, 13 * ms)]
    host = [("outer", 0, 11 * ms), ("aten::copy_", 5 * ms, 8 * ms)]
    s = tracing.reduce_events(device, host, 0, 10 * ms)
    assert s["window_s"] == pytest.approx(0.010)
    # busy [0, 5] and [8, 9]; "late" lies outside the window
    assert s["busy_s"] == pytest.approx(0.006)
    assert s["kernels"]["conv"] == [pytest.approx(0.005), 2]
    assert "late" not in s["kernels"]
    assert s["device_ops"][0] == ["conv", pytest.approx(0.005)]
    # the gap [5, 8] falls under the innermost host op, [9, 10] under outer
    assert dict(s["idle_gaps"]) == {"aten::copy_": pytest.approx(0.003),
                                    "outer": pytest.approx(0.001)}


def _reader(name):
    return harness.load_module(ROOT / "bench_port" / "metrics" / f"{name}.py")


def _ctx(**tallies):
    net = importlib.import_module("bench_port.reference.nets.resnet18")
    t = {"net": net, "window_s": 2.0, "stages": {}, **tallies}
    return {"cfg": CFG, "tallies": t,
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "busy_s": 1.5, "window_s": 2.0},
            "trace": {"kernels": {"void resize_pad_kernel<float>": [0.01, 4],
                                  "conv": [1.0, 9]}}}


def test_readers_on_canned_numbers():
    fwd = flops.forward_flops(_ctx()["tallies"]["net"], CFG)
    ctx = _ctx(rois=20000, dtype="float32", shipped_pixels=4000 * 20000,
               stages={"host.decode+pack": 0.5, "host.meta": 0.3,
                       "device.drain": 1.2})
    assert _reader("mfu.rois").read(ctx) == pytest.approx(
        100 * fwd * 20000 / 2.0 / 67e12)
    assert _reader("device_idle_pct.rois").read(ctx) == pytest.approx(25.0)
    assert _reader("host_pack_ms_per_kroi").read(ctx) == pytest.approx(40.0)
    assert _reader("drain_wait_ms_per_kroi").read(ctx) == pytest.approx(60.0)
    least = flops.k1_eval_bytes(4000 * 20000, 20000, 180, 3,
                                "float32") / 3.35e12
    assert _reader("k1_roofline.rois").read(ctx) == pytest.approx(
        100 * least / 0.01)
    ctx = _ctx(images=6400, dtype="bfloat16", shipped_pixels=6400 * 4000)
    assert _reader("mfu.train").read(ctx) == pytest.approx(
        100 * 3 * fwd * 6400 / 2.0 / 989e12)
    assert _reader("device_idle_pct.train").read(ctx) == pytest.approx(25.0)
    least = flops.k1_train_bytes(6400 * 4000, 6400, 180, 3,
                                 "bfloat16") / 3.35e12
    assert _reader("k1_roofline.train").read(ctx) == pytest.approx(
        100 * least / 0.01)


def test_readers_return_nothing_without_a_card():
    ctx = _ctx(rois=100, images=100, dtype="float32", shipped_pixels=1000)
    ctx["device"] = {"platform": "cpu", "kind": "cpu", "busy_s": 0.0,
                     "window_s": 1.0}
    ctx["trace"]["kernels"] = {}
    for m in BENCH["per_layer"]:
        if m["source"] != "program_span":
            assert _reader(m["name"]).read(ctx) is None, m["name"]
