"""Nothing the benchmark runs loads JAX, its libraries or the JAX package:
every cell, the staged ones too, run on the CPU at a tiny size in a fresh
interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

from bench_port.tests.tiny import ROOT

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from bench_port import harness
from bench_port.tests.tiny import run_tiny, staged_bench, tiny_plan
for w in staged_bench()["workloads"]:
    run_tiny(tiny_plan(w["name"]), trace=True)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in {forbidden!r})))
"""


def test_no_jax_in_any_cell():
    forbidden = set(harness_forbidden())
    assert {"jax", "jaxlib", "flax", "optax", "sykepic_tpu"} <= forbidden
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT),
                                             forbidden=sorted(forbidden))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded == []


def harness_forbidden():
    from bench_port import harness

    return harness.FORBIDDEN


def test_forbidden_names_are_whole_top_level_names():
    from bench_port import harness

    saved = dict(sys.modules)
    try:
        sys.modules["sykepic_tpu_torch_probe"] = object()
        sys.modules["jaxfoo"] = object()
        assert harness.forbidden_modules() == [
            m for m in sorted(saved) if m.split(".")[0] in harness.FORBIDDEN]
        sys.modules["sykepic_tpu.probe"] = object()
        assert "sykepic_tpu.probe" in harness.forbidden_modules()
    finally:
        for k in ("sykepic_tpu_torch_probe", "jaxfoo", "sykepic_tpu.probe"):
            sys.modules.pop(k, None)
