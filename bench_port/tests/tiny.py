"""Cells cut to a size the CPU runs in seconds (32x32 inputs, a few hundred
ROIs or images), for the benchmark's CPU tests."""

from __future__ import annotations

import time

import torch

from bench_port import harness
from bench_port.harness import HERE

ROOT = HERE.parent
TINY = 32
SEED = 2**31 + 11  # larger than 32 signed bits hold


def shrink(plan: dict) -> dict:
    """``plan`` (of :func:`harness.cell_plan`) at the tiny size."""
    cfg = plan["cfg"]
    cfg["image_shape"] = [3, TINY, TINY]
    cfg["ini"]["image"]["shape"] = f"3, {TINY}, {TINY}"
    cfg["calibration_rois"] = 32
    t = plan["traffic"]
    if t["path"] == "prob":
        t["pool"].update(samples=2, rois_per_sample=[40, 60])
        t.update(samples_per_job=1, batch_size=64, check_rois=50)
    else:
        t["set"].update(images=300)
        t.update(batch_size=64)
        # float32 here: the CPU's bfloat16 rounding is not the card's
        cfg["dtype"]["train"] = "float32"
    return plan


# Cells built and tested here that BENCHMARK.json does not hold yet, each
# with the end-to-end metric it reports besides set-up: the train cell's
# check does not yet separate its float8 control from the program (PERF.md,
# Open questions).
STAGED = [({"name": "resnet18.train.steady", "config": "resnet18",
            "traffic": "train_steady", "chips": 1},
           {"name": "train_images_per_s", "unit": "images/s",
            "better": "higher", "source": "host_clock"})]


def staged_bench() -> dict:
    """``BENCHMARK.json`` with the staged cells added."""
    bench = harness.read_json(ROOT / harness.BENCHMARK)
    for cell, metric in STAGED:
        bench["workloads"].append(cell)
        bench["end_to_end"].append(dict(metric, workloads=[cell["name"]]))
    return bench


def tiny_plan(cell: str, bench: dict | None = None) -> dict:
    return shrink(harness.cell_plan(bench or staged_bench(), cell))


def run_tiny(plan: dict, seconds: float = 0.5, trace: bool = False,
             seed: int = SEED) -> dict:
    return harness.run_cell(plan, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())
