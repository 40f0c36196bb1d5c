"""Build and load the port's CUDA kernels (``sykepic_tpu_torch/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its own
shared library for ``sm_90a``, loaded with ctypes. Nothing builds when a
module is imported: :func:`load` builds at a kernel's first launch, and
:func:`build_all` starts one ``nvcc`` per source together (the smoke run
uses it so the build time is that of the slowest file, not the sum).

Libraries land in ``build/kernels/`` beside the package, named by a hash of
the source and flags, so a stale build is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no FMA contraction: the kernels must round like their plain versions
    "-fmad=false",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(process or None, temp path, final path)``."""
    out = library_path(name)
    if out.is_file():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, float]:
    """Build every ``csrc/*.cu`` with one ``nvcc`` each, all started
    together. Returns seconds per source (time from the common start to
    that build's end; 0 when already built)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    seconds = {}
    for n, (proc, tmp, out) in started.items():
        _finish(n, proc, tmp, out)
        seconds[n] = 0.0 if proc is None else time.perf_counter() - t0
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, *_start(name))
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
