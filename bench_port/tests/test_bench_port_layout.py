"""BENCHMARK.json and the files the harness finds by name."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from bench_port import harness

from bench_port.tests.tiny import ROOT, run_tiny, shrink

BENCH = harness.read_json(ROOT / harness.BENCHMARK)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    plan = harness.cell_plan(BENCH, cell)
    assert harness.plan_module(plan, "paths", plan["traffic"]["path"]).Run
    net = harness.plan_module(plan, "reference", "nets",
                              plan["cfg"]["network"])
    assert net.param_specs(plan["cfg"])
    for m in plan["per_layer"]:
        assert callable(harness.plan_module(plan, "metrics", m["name"]).read)
    assert plan["limits"]
    names = {m["name"] for m in plan["e2e"]}
    assert "setup_s" in names and len(names) >= 2
    assert plan["per_layer"]


def test_names_and_units():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({e["name"] for e in named}) == len(named)


def test_metrics_cover_every_cell():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def _digest(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench_port").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_entries_need_no_edit(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added as
    new files and entries run with every existing file as it was."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_port", copy / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(copy)
    base = copy / "bench_port"
    cfg = json.loads((base / "configs" / "resnet18.json").read_text())
    cfg["logit_std"] = 4.0
    (base / "configs" / "resnet18_alt.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "prob_archive.json").read_text())
    traffic["samples_per_job"] = 2
    (base / "traffic" / "prob_pairs.json").write_text(json.dumps(traffic))
    limits = (base / "limits" / "resnet18.prob.archive.json").read_text()
    (base / "limits" / "resnet18_alt.prob.pairs.json").write_text(limits)
    (base / "metrics" / "jobs_run.py").write_text(
        "def read(ctx):\n    return float(ctx['tallies']['jobs'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "resnet18_alt", "source": "test",
                             "file": "bench_port/configs/resnet18_alt.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "resnet18_alt.prob.pairs",
                               "config": "resnet18_alt",
                               "traffic": "prob_pairs", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "rois_per_s":
            m["workloads"].append("resnet18_alt.prob.pairs")
    bench["per_layer"].append({"name": "jobs_run", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "Engine",
                               "moves": "rois_per_s",
                               "workloads": ["resnet18_alt.prob.pairs"]})
    plan = shrink(harness.cell_plan(bench, "resnet18_alt.prob.pairs", copy))
    plan["traffic"]["samples_per_job"] = 2
    result = run_tiny(plan, trace=True)
    assert result["correct"]
    assert result["metrics"]["jobs_run"]["value"] >= 1
    after = _digest(copy)
    assert {p: d for p, d in after.items() if p in before} == before
