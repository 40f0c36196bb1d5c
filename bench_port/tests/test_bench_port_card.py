"""The controls of the cells' checks on the card: the plain reference one
precision below the configuration's, or a planted fault, in the program's
place, driven through the harness as a run drives it, has to make
``correct`` false. The `prob` cells run on two samples of their pool, the
train cell at its own size (its limits hold for its batch plans; about 20 s
a seed and control). Run on the card with
``python -m pytest bench_port/tests/test_bench_port_card.py``; skips
without one."""

from __future__ import annotations

import time

import pytest

from bench_port import harness

BENCH = harness.read_json(harness.HERE.parent / harness.BENCHMARK)
SEEDS = (2147483659, 2147483693, 2147483711)


def _plan(cell):
    plan = harness.cell_plan(BENCH, cell)
    t = plan["traffic"]
    if t["path"] == "prob":
        t["pool"].update(samples=2)
        t["check_rois"] = 1024
    return plan


def _controls():
    for w in BENCH["workloads"]:
        plan = harness.cell_plan(BENCH, w["name"])
        path_mod = harness.plan_module(plan, "paths", plan["traffic"]["path"])
        for name in path_mod.CONTROLS:
            yield w["name"], name


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,control", list(_controls()))
def test_control_fails_the_check(cell, control, seed, cuda_device):
    plan = dict(_plan(cell), control=control)
    result = harness.run_cell(plan, seed, 0.5, False, cuda_device,
                              time.perf_counter())
    assert not result["correct"], result["checks"]
