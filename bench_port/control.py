"""The control of a cell's correctness check: the plain reference put in
the program's place, one precision below the configuration's, or a fault
planted in the program. Each has to come out as not correct.

    python3 bench_port/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds <s>] [--readings]

For each seed and each name in the path module's ``CONTROLS`` it runs the
cell as the benchmark does (``harness.run_cell``, a window of ``--seconds``,
1 by default) with ``plan["control"]`` set to that name, and prints one JSON
line: ``{"workload", "seed", "control", "correct", "checks"}``, each number
compared beside its limit. With ``--readings`` it prints instead the path
module's ``control()`` readings of the numbers compared and of those left
aside, for the program, the control and the faults on the same inputs
(the train path's; no window). Runs on a CUDA card, at the cell's own size.
The benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--readings", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    plan = harness.cell_plan(harness.read_json(ROOT / harness.BENCHMARK),
                             args.workload)
    path_mod = harness.plan_module(plan, "paths", plan["traffic"]["path"])
    limits = {k: v["limit"] for k, v in plan["limits"].items()}
    for seed in args.seeds:
        if args.readings:
            net = harness.plan_module(plan, "reference", "nets",
                                      plan["cfg"]["network"])
            work = Path(tempfile.mkdtemp(prefix="bench_port-control-"))
            try:
                readings = path_mod.control(plan, seed, work, device, net)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": readings, "limits": limits}),
                  flush=True)
            continue
        for name in path_mod.CONTROLS:
            result = harness.run_cell(dict(plan, control=name), seed,
                                      args.seconds, False, device,
                                      time.perf_counter())
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": name,
                              "correct": result["correct"],
                              "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
