"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a profiled window). The last line of
standard output is the result object; the numbers compared with the plain
reference, each beside its limit, close both it and standard error. Exits
non-zero, printing no result, without a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed places inside the checkout, so that only
# a cell's first run in a checkout builds (the port's nvcc output already
# lands in build/kernels/)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from bench_port import harness

    plan = harness.cell_plan(
        harness.read_json(ROOT / harness.BENCHMARK), args.workload)
    import torch

    chips = plan["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(plan, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
