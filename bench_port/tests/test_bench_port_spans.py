"""The readers of the program's own spans and counters in the ``prob``
path (``engine.wait_input``, ``prob.job_close``, ``prob.csv_write``,
``engine.rois`` over ``engine.slots``): each on canned numbers, each silent
where the program recorded none of its names, and all four read from a
tiny traced run of both ``prob`` cells on the CPU."""

from __future__ import annotations

import pytest

from bench_port import harness

from bench_port.tests.tiny import ROOT, run_tiny, tiny_plan

BENCH = harness.read_json(ROOT / harness.BENCHMARK)
PROB_CELLS = ["resnet18.prob.archive", "efficientnet_b0.prob.archive"]

# reader -> (the stages it reads, the value they give over 20,000 ROIs)
CANNED = {
    "input_wait_ms_per_kroi": ({"engine.wait_input": 0.1}, 5.0),
    "job_close_ms_per_kroi": ({"prob.job_close": 0.04}, 2.0),
    "csv_write_ms_per_kroi": ({"prob.csv_write": 0.12}, 6.0),
    "slot_fill_pct": ({"engine.rois": 20000, "engine.slots": 20480},
                      100 * 20000 / 20480),
}


def _reader(name):
    return harness.load_module(ROOT / "bench_port" / "metrics" / f"{name}.py")


def _ctx(stages, rois=20000):
    return {"tallies": {"rois": rois, "window_s": 2.0, "stages": stages},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "busy_s": 1.5, "window_s": 2.0},
            "trace": {"kernels": {}}}


@pytest.mark.parametrize("name", sorted(CANNED))
def test_reader_on_canned_numbers(name):
    stages, want = CANNED[name]
    others = {"host.decode+pack": 0.5, "device.drain": 1.2}
    assert _reader(name).read(_ctx({**others, **stages})) == pytest.approx(
        want)


@pytest.mark.parametrize("name", sorted(CANNED))
def test_reader_is_silent_without_its_names(name):
    # a program that records only the older stages, as the parent did
    ctx = _ctx({"host.decode+pack": 0.5, "host.meta": 0.3,
                "device.drain": 1.2})
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name", sorted(CANNED))
def test_declared_for_both_prob_cells(name):
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert entry["workloads"] == PROB_CELLS
    assert entry["moves"] == "rois_per_s"


@pytest.mark.parametrize("cell", PROB_CELLS)
def test_tiny_traced_run_reads_all_four(cell):
    result = run_tiny(tiny_plan(cell), trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert set(CANNED) <= set(metrics)
    for name in ("input_wait_ms_per_kroi", "job_close_ms_per_kroi",
                 "csv_write_ms_per_kroi"):
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms"
    assert 0 < metrics["slot_fill_pct"]["value"] <= 100
    assert metrics["slot_fill_pct"]["unit"] == "%"
