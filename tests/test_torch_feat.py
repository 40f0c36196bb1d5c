"""``python -m sykepic_tpu_torch feat`` against the JAX package's
``feature_native.main`` (and its CLI adapter), in-process on the CPU: on
the fixture sample and two seeded samples in ``bench.py``'s size mix the
port writes the same ``.feat.csv`` bytes, with and without ``--parallel``
(a ``spawn`` pool on both sides); skip-if-exists, ``-f`` and the 1 GB
``.roi`` filter behave as in JAX; the MATLAB route's contract is pinned
with the stub executable of ``tests/test_feature_matlab.py`` against the
JAX backend's invocations and output, and without pandas it raises a clear
``ImportError`` before MATLAB runs; the ``feat`` path imports neither
torch nor pandas (each ``spawn`` worker imports it afresh).
"""

import json
import os
import shutil
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from sykepic_tpu.compute import feature as jax_feature
from sykepic_tpu.compute import feature_matlab as jax_matlab
from sykepic_tpu.compute import feature_native as jax_native
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.compute import feature_matlab
from sykepic_tpu_torch.utils import files
from test_feature_matlab import _make_stub
from test_torch_features import write_seeded_sample

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests/data/raw/valid/D20180712T065600_IFCB114"
SEEDED = ("D20180712T070100_IFCB114", "D20190301T101500_IFCB114")

Args = namedtuple("Args", "raw samples out matlab parallel force")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    raw = tmp_path_factory.mktemp("raw")
    for suffix in (".adc", ".roi", ".hdr"):
        shutil.copy(FIXTURE.with_suffix(suffix), raw)
    for seed, name in enumerate(SEEDED):
        write_seeded_sample(raw, name, 6 + 2 * seed, seed=21 + seed)
    return raw


def _csvs(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(Path(root).rglob("*.feat.csv"))}


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "spawn"])
def test_feat_cli_writes_jax_bytes(raw_dir, tmp_path, parallel):
    got = main(["feat", "-r", str(raw_dir), "-o", str(tmp_path / "port")]
               + (["-p"] if parallel else []))
    want = jax_native.main(files.list_sample_paths(raw_dir),
                           tmp_path / "jax", parallel=parallel)
    assert got == want == {FIXTURE.name, *SEEDED}
    mine, theirs = _csvs(tmp_path / "port"), _csvs(tmp_path / "jax")
    assert len(mine) == 3 and mine == theirs
    for body in mine.values():
        assert body.startswith(b"# version=tpu-v1\n# volume_ml=")


def test_skip_if_exists_and_force(raw_dir, tmp_path):
    argv = ["feat", "-s", str(raw_dir / SEEDED[0]), "-o", str(tmp_path)]
    assert main(argv) == {SEEDED[0]}
    (csv,) = tmp_path.rglob("*.feat.csv")
    csv.write_text("stale")
    assert main(argv) == {SEEDED[0]}  # exists: skipped, left as it is
    assert csv.read_text() == "stale"
    assert main(argv + ["-f"]) == {SEEDED[0]}
    jax_native.main([raw_dir / SEEDED[0]], tmp_path / "jax")
    assert csv.read_bytes() == _csvs(tmp_path / "jax")[
        csv.relative_to(tmp_path)]


def test_one_gigabyte_filter(raw_dir, tmp_path):
    """A sample whose ``.roi`` is over 1e9 bytes (sparse here) is skipped
    by both CLIs, never decoded."""
    raw = tmp_path / "raw"
    shutil.copytree(raw_dir, raw)
    big = "D20180712T080000_IFCB114"
    for suffix in (".adc", ".hdr"):
        shutil.copy(FIXTURE.with_suffix(suffix), raw / f"{big}{suffix}")
    with open(raw / f"{big}.roi", "wb") as fh:
        fh.truncate(int(1e9) + 1)
    got = main(["feat", "-r", str(raw), "-o", str(tmp_path / "port")])
    want = jax_feature.call(Args(str(raw), None, tmp_path / "jax", None,
                                 False, False))
    assert got == want == {FIXTURE.name, *SEEDED}
    assert _csvs(tmp_path / "port") == _csvs(tmp_path / "jax")


def _calls(stub_dir, out_dir):
    """The stub's recorded invocations, with the run's own directories
    (the output root, the temporary staging dir) taken out."""
    calls = [json.loads(line) for line in
             (stub_dir / "calls.jsonl").read_text().splitlines()]
    for call in calls:
        call["paths"] = [str(Path(p).relative_to(Path(out_dir).resolve()))
                         if p.startswith(str(Path(out_dir).resolve())) else p
                         for p in call["paths"][1:]]
        call["cmd"] = call["cmd"].split("(")[0]
    return calls


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "par"])
def test_matlab_route_matches_jax_with_stub(raw_dir, tmp_path, parallel):
    samples = [FIXTURE, raw_dir / SEEDED[0]]
    mine_bin, theirs_bin = tmp_path / "port_bin", tmp_path / "jax_bin"
    mine_bin.mkdir()
    theirs_bin.mkdir()
    out, jout = tmp_path / "port", tmp_path / "jax"
    got = main(["feat", "-s", *map(str, samples), "-o", str(out),
                "-m", str(_make_stub(mine_bin))]
               + (["-p"] if parallel else []))
    want = jax_matlab.main(str(_make_stub(theirs_bin)), samples, jout,
                           parallel)
    assert got == want == {FIXTURE.name, SEEDED[0]}
    calls = _calls(mine_bin, out)
    assert calls == _calls(theirs_bin, jout) and len(calls) == 2
    assert calls[0]["par"] == ("true" if parallel else "")
    mine, theirs = _csvs(out), _csvs(jout)
    assert len(mine) == 2 and mine == theirs
    assert all(b.startswith(b"# version=2\n") for b in mine.values())


def test_matlab_route_without_pandas_raises_first(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        feature_matlab.main(str(_make_stub(tmp_path)), [FIXTURE],
                            tmp_path / "out", False)
    assert not (tmp_path / "calls.jsonl").exists()  # MATLAB never ran


_NO_TORCH = """
import sys
BLOCKED = ("torch", "jax", "sykepic_tpu", "pandas", "cv2")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
from sykepic_tpu_torch.__main__ import main
print(sorted(main(["feat", "-r", sys.argv[1], "-o", sys.argv[2]])))
"""


def test_feat_path_imports_no_torch(raw_dir, tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _NO_TORCH, str(raw_dir), str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-2] == str(sorted({FIXTURE.name, *SEEDED}))
    assert len(_csvs(tmp_path)) == 3
