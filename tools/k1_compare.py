#!/usr/bin/env python3
"""K1, the resize/pad kernel of the PyTorch/CUDA port, in this checkout
against K1 in another checkout of the repo, on one card, on the same inputs
in the same run. Run from the root of this checkout, on a machine with a
card, with the other checkout unpacked into a git-ignored directory, e.g.
the parent commit::

    mkdir -p build/k1_other
    git archive HEAD~1 | tar -x -C build/k1_other
    python3 tools/k1_compare.py build/k1_other

Each side is called through its own wrapper,
``sykepic_tpu_torch/ops/resize_pad.py::resize_pad`` (the other checkout's
package is loaded under another name), so whatever C interface and launch
plan each kernel has, each builds from its own ``csrc/resize_pad.cu`` into
its own ``build/kernels/``. Both sources are also built with
``ops/cuda_build.py``'s flags plus ``-Xptxas -v``: the registers, shared
memory and spills ptxas reports are printed, and the store instructions in
each SASS (``cuobjdump -sass``: ``STG.E.128`` 16-byte stores, ``UBLKCP``
bulk copies).

Inputs, built as ``chip_smoke.py`` builds them: ``prob``'s first shelf
dispatch of the fixture plus 20,000 synthetic ROIs (``-b 2048``, 3
channels, f32 and bf16); and 2,048 train-form slots of the largest store of
the synthetic train set (3,000 PNGs, seed 11, one device-resident set of
all of them, the rows of one stratified epoch), f32 and bf16, brightness on
and off. For each case both are checked against this checkout's plain
version (max |diff|), then timed in turns, other, this, this, other: the
device time of a recorded kernel (torch.profiler over 20 calls), 20
back-to-back calls between two CUDA events, and the host us a call (100
calls without a synchronisation). This checkout's kernel is also timed
writing into an output one element into its buffer (where it takes the
vector store path), and ``out.copy_(other)`` on an equal output gives the
copy floor. One JSON line a case on stdout; all of them in
``build/k1_compare/k1_compare.json``, a directory the tool empties first.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
WORK = REPO / "build" / "k1_compare"
OTHER = "k1_other_checkout"  # the name the other checkout's package takes
REPS = 20


def load_other(root: Path):
    """The other checkout's ``ops.resize_pad`` module, its package loaded
    under :data:`OTHER` (the package's modules import each other
    relatively)."""
    pkg = root / "sykepic_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{OTHER}.ops.resize_pad")


def build(src: Path, name: str):
    """Start nvcc for ``src`` into ``WORK/lib<name>.so`` with the port's
    flags and ``-Xptxas -v``."""
    from sykepic_tpu_torch.ops import cuda_build

    out = WORK / f"lib{name}.so"
    proc = subprocess.Popen(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, out


def ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def sass_stores(lib: Path) -> dict:
    """Store and bulk-copy opcodes a kernel of ``lib``'s SASS holds."""
    from sykepic_tpu_torch.ops import cuda_build

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.search(r"\b(STG\.\S+|STS\.\S+|STS|STG|UBLKCP\S*|"
                      r"SYNCS\S*|LDG\.\S+)", ln)
        if fn and m:
            op = m.group(1).rstrip(";")
            counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


def times(smoke, fn) -> dict:
    prof, n = smoke.profiled_kernels(fn, "resize_pad", REPS)
    return {"device_ms": prof / n if n else None,
            "loop_ms": smoke.loop_ms(fn, REPS),
            "host_us": smoke.host_us(fn)}


def compare(smoke, other, name, pix, meta, dtype, bound_ms, **kw) -> dict:
    from sykepic_tpu_torch.ops import preprocess, resize_pad

    shape = (meta.shape[1], 180, 180, 3)
    n = int(np.prod(shape))
    shifted = torch.empty(n + 1, dtype=dtype, device=pix.device)[1:].view(
        shape)

    def this():
        return resize_pad.resize_pad(pix, meta, 180, 180, 3, dtype, **kw)

    def that():
        return other.resize_pad(pix, meta, 180, 180, 3, dtype, **kw)

    def vector():
        return resize_pad.resize_pad(pix, meta, 180, 180, 3, dtype,
                                     out=shifted, **kw)

    want = preprocess.resize_pad_plain(pix, meta, 180, 180, 3, dtype, **kw)
    before = resize_pad.vector_launches
    got, old, vec = this(), that(), vector()
    torch.cuda.synchronize()
    if resize_pad.vector_launches != before + 1:
        raise RuntimeError("the shifted output did not take the vector path")

    def err(t):
        return float((t.float() - want.float()).abs().max())

    runs: dict = {}
    for tag, fn in (("other", that), ("this", this), ("this", this),
                    ("other", that), ("this_vector", vector)):
        runs.setdefault(tag, []).append(times(smoke, fn))
    out = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "slots": int(meta.shape[1]),
           "store": resize_pad.plan(180, 180, 3, dtype, got.data_ptr(),
                                    bright=kw.get("bright") is not None).store,
           "max_abs_err": {"this": err(got), "other": err(old),
                           "this_vector": err(vec)},
           "bound_ms": bound_ms, "copy_floor_ms": smoke.copy_floor_ms(got)}
    for tag, rs in runs.items():
        out[tag] = rs
        dev = [r["device_ms"] for r in rs if r["device_ms"]]
        if dev:
            out[f"{tag}_share_of_bound"] = bound_ms / (sum(dev) / len(dev))
    print(json.dumps(out), flush=True)
    return out


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA card", file=sys.stderr)
        return 1
    other_root = Path(argv[1]).resolve()
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from sykepic_tpu_torch.ops import cuda_build
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.device_data import DeviceDataset

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    other = load_other(other_root)
    src = "sykepic_tpu_torch/csrc/resize_pad.cu"
    builds = {"this": build(REPO / src, "k1_this"),
              "other": build(other_root / src, "k1_other")}
    # each wrapper's own library, built while ptxas reports
    cuda_build.load("resize_pad")
    other.cuda_build.load("resize_pad")
    ptxas, sass = {}, {}
    for tag, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {tag} source:\n{log}")
        ptxas[tag] = ptxas_lines(log)
        sass[tag] = sass_stores(lib)
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "ptxas": ptxas,
                      "sass_stores": sass}), flush=True)
    dev = torch.device("cuda")
    results = []

    # prob's first shelf dispatch
    model_dir = smoke.build_model_dir(WORK)
    counts = smoke.build_raw(WORK / "raw", smoke.N_ROIS, 42,
                             datetime(2018, 7, 12))
    windows, meta = smoke.first_shelf_dispatch(model_dir, list(counts))
    pix = torch.from_numpy(windows).to(dev)
    m = torch.from_numpy(meta).to(dev)
    h, w = meta[3].astype(np.int64), meta[4].astype(np.int64)
    read = min(int((h * w).sum()), windows.size) + meta.nbytes
    for dtype in (torch.float32, torch.bfloat16):
        written = meta.shape[1] * 180 * 180 * 3 * (
            4 if dtype == torch.float32 else 2)
        bound = 1e3 * (read + written) / smoke.MEMORY_BYTES_PER_S
        results.append(compare(smoke, other, "shelf_first_dispatch", pix, m,
                               dtype, bound))

    # 2,048 train-form slots of the synthetic train set's largest store
    dataset = smoke.build_train_set(WORK / "dataset", seed=11)
    paths = sorted(dataset.rglob("*.png"))
    ds = DeviceDataset(paths, None, PreprocessSpec(180, 180, 3),
                       batch_size=256, seed=0, shuffle=True, device=dev)
    stores, idxs, _ = ds.epoch_mixed_stacked()
    inp = smoke.train_form_inputs(stores, idxs, smoke.TRAIN_SLOTS)
    for tag, on, dtype in smoke.TRAIN_FORM_CASES:
        bright = inp["bright"] if on else None
        written = smoke.TRAIN_SLOTS * 180 * 180 * 3 * (
            4 if dtype == torch.float32 else 2)
        nbytes = inp["read"] + written + (0 if bright is None
                                          else bright.nbytes)
        results.append(compare(
            smoke, other, f"train_{tag}", inp["pixels"], inp["meta"], dtype,
            1e3 * nbytes / smoke.MEMORY_BYTES_PER_S,
            affine=inp["affine"], bright=bright))
    (WORK / "k1_compare.json").write_text(json.dumps(
        {"card": smi, "ptxas": ptxas, "sass_stores": sass,
         "cases": results}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
