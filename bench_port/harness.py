"""One run of one cell: everything between the command line and the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name:

- ``BENCHMARK.json`` at the checkout's root names the cell's configuration
  and traffic, and which metrics the cell reports;
- ``configs/<config>.json``: the model configuration (network, shapes,
  dtypes, the ``config.ini`` the port reads, the class names, the weights'
  rule); its plain network is ``reference/nets/<network>.py``;
- ``traffic/<traffic>.json``: the mix; its ``path`` names the path module
  ``paths/<path>.py`` that sets the program up, drives the window and
  checks what the window produced;
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares, with the readings it was set from;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``
  returning the number or None (nothing to read: the metric is left out).

A path module has ``Run(plan, seed, work, device, net)`` (``plan``: of
:func:`cell_plan`) with
``setup()``, ``window(seconds)`` (returns the end-to-end metrics but
``setup_s``, and the tallies the readers read), ``memory_peak_bytes()``,
``free()`` and ``check()`` (returns ``(checks, attempted, failed)``,
``checks`` mapping a name to ``(value, limit)``, correct while every value
is at most its limit), and ``CONTROLS``: the names that
``plan["control"]`` may take to put the check's control, or a planted
fault, in the program's place (``control.py``).
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sykepic_tpu")


def load_module(path: Path, root: Path = HERE.parent):
    """Import the Python file ``path`` (under ``root``, the checkout) as a
    module of the benchmark's package (its name may hold dots)."""
    rel = path.resolve().relative_to(root.resolve()).with_suffix("")
    name = ".".join(p.replace(".", "_") for p in rel.parts)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_plan(bench: dict, cell: str, root: Path = HERE.parent) -> dict:
    """The cell's entry, configuration, traffic, limits and metric lists,
    read from the checkout at ``root``."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in {BENCHMARK}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    base = root / HERE.name
    cfg = read_json(root / config["file"])
    traffic = read_json(base / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(base / "limits" / f"{cell}.json")

    def mine(m):
        return cell in m.get("workloads", [cell])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and m["moves"] in names]
    return {"entry": entry, "cfg": cfg, "traffic": traffic,
            "limits": limits, "e2e": e2e, "per_layer": layer, "root": root}


def plan_module(plan: dict, *parts: str):
    """The module ``bench_port/<parts...>.py`` of the plan's checkout."""
    return load_module(plan["root"].joinpath(HERE.name, *parts[:-1],
                                             f"{parts[-1]}.py"),
                       plan["root"])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def run_cell(plan: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Set up, measure, check; returns the result object (without
    printing). ``t_start`` is the process's start on ``time.perf_counter``:
    set-up runs from it to the window. Inputs and outputs live in a
    directory of ``TMPDIR``, removed at the end."""
    from . import tracing

    cfg, traffic = plan["cfg"], plan["traffic"]
    net = plan_module(plan, "reference", "nets", cfg["network"])
    path_mod = plan_module(plan, "paths", traffic["path"])
    work = Path(tempfile.mkdtemp(prefix="bench_port-"))
    try:
        run = path_mod.Run(plan, seed, work, device, net)
        run.setup(trace=trace)
        setup_s = time.perf_counter() - t_start
        if trace:
            with tracing.DeviceTrace() as tr:
                measured = run.window(seconds)
            summary = tr.summary
        else:
            measured = run.window(seconds)
            summary = None
        dev = device_info(device)
        if device.type == "cuda":
            dev["memory_peak_bytes"] = run.memory_peak_bytes()
        run.free()
        checks, attempted, failed = run.check()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = forbidden_modules()
    if found:
        raise RuntimeError("modules of JAX or the JAX package loaded: "
                           + ", ".join(found))
    values = dict(measured["e2e"], setup_s=setup_s)
    result = {"correct": all(v <= lim for v, lim in checks.values())
              and failed == 0,
              "attempted": attempted, "failed": failed}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        ctx = {"cfg": cfg, "traffic": traffic, "tallies": measured["tallies"],
               "trace": summary, "device": dev}
        metrics = {}
        for m in plan["per_layer"]:
            reader = plan_module(plan, "metrics", m["name"])
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    else:
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in plan["e2e"]}
        result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
