"""The port's native host library builds once under concurrent loaders
(``sykepic_tpu_torch/ingest/native/__init__.py::lib``): on a fresh copy of
its directory, six processes call ``lib()`` at once and all six load it;
a library built for another host, or older than its source, is rebuilt
under the lock rather than loaded."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
NATIVE = REPO / "sykepic_tpu_torch" / "ingest" / "native"

# imports the copy by path, so it builds into its own directory
_LOAD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print("loaded" if mod.lib() is not None else "none")
"""


def _fresh_copy(root: Path) -> Path:
    d = root / "native"
    d.mkdir()
    for name in ("__init__.py", "Makefile", "ifcb_native.cpp"):
        shutil.copy(NATIVE / name, d / name)
    return d


def _load(d: Path, n: int) -> list:
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD,
                               str(d / "__init__.py")],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(n)]
    return [p.communicate(timeout=240)[0].strip() for p in procs]


def test_six_concurrent_loaders_all_load(tmp_path):
    d = _fresh_copy(tmp_path)
    assert _load(d, 6) == ["loaded"] * 6
    assert (d / "libifcb_native.so").is_file()
    assert (d / ".buildhost").is_file()
    # no per-pid build is left behind
    assert not list(d.glob("libifcb_native.*.tmp.so"))


def test_stale_library_is_rebuilt_not_loaded(tmp_path):
    d = _fresh_copy(tmp_path)
    assert _load(d, 1) == ["loaded"]
    so = d / "libifcb_native.so"
    (d / ".buildhost").write_text("another-host\n")
    before = so.stat().st_mtime_ns
    assert _load(d, 3) == ["loaded"] * 3
    assert so.stat().st_mtime_ns != before
    assert (d / ".buildhost").read_text().strip() != "another-host"
    # a source newer than the library also rebuilds it
    old = (d / "ifcb_native.cpp").stat().st_mtime - 100
    os.utime(so, (old, old))
    assert _load(d, 2) == ["loaded"] * 2
    assert so.stat().st_mtime >= (d / "ifcb_native.cpp").stat().st_mtime
