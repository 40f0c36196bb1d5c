"""The host-thread ``pipeline`` (no ``--device-features``) of the port
against the JAX package's, on the CPU: ``python -m sykepic_tpu_torch
pipeline ... --device cpu`` beside ``sykepic_tpu.compute.pipeline.main`` on
the conftest's ``model_dir``, over the fixture sample, a seeded sample in
``bench.py``'s size mix plus one ROI wider than the 180 px input (the host
pre-shrink), and a sample with no ROI.

Bounds: ``.feat.csv`` byte-identical to JAX's (``# version=tpu-v1``);
``.prob.csv`` with the same ROI ids and argmax, probabilities within
1.2e-5 (one 1e-5 quantum); the returned set names exactly the samples
whose two CSVs both landed (a sample whose feature job fails keeps its
prob CSV and is left out, as in JAX); on two gloo ranks under ``torchrun``
the outputs equal one rank's within the same bounds.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from sykepic_tpu.compute import pipeline as jax_pipeline
from sykepic_tpu.compute import probability as jax_probability
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.compute import pipeline
from sykepic_tpu_torch.ops import resize_pad
from sykepic_tpu_torch.utils import files
from test_torch_features import seeded_rois

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests/data/raw/valid/D20180712T065600_IFCB114"
SEEDED = "D20180712T070100_IFCB114"
EMPTY = "D20180712T070500_IFCB114"
WIDE = (60, 200)  # one ROI over the 180 px input
QUANTUM_BOUND = 1.2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    raw = tmp_path_factory.mktemp("raw")
    for suffix in (".adc", ".roi", ".hdr"):
        shutil.copy(FIXTURE.with_suffix(suffix), raw)
    imgs = seeded_rois(9, seed=31)
    imgs.insert(4, np.random.default_rng(32).integers(
        0, 256, WIDE, dtype=np.uint8))
    bench._write_sample_triplet(raw, SEEDED, imgs)
    bench._write_sample_triplet(raw, EMPTY, [])
    return raw


def _port(raw, model_dir, out, *extra):
    return main(["pipeline", "-r", str(raw), "-m", str(model_dir), "-o",
                 str(out), "-b", "4", "--device", "cpu", *extra])


def _jax(raw, model_dir, out):
    clf = jax_probability.prepare_model(model_dir, batch_size=4)
    return jax_pipeline.main(files.list_sample_paths(raw), clf, out)


@pytest.fixture(scope="module")
def both_runs(raw_dir, model_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_host")
    before = resize_pad.launches
    written = _port(raw_dir, model_dir, out / "port")
    assert resize_pad.launches == before  # the CPU takes K1's plain version
    jax_written = _jax(raw_dir, model_dir, out / "jax")
    return written, jax_written, out / "port", out / "jax"


def _csvs(root, suffix):
    return {p.relative_to(root): p
            for p in sorted(Path(root).rglob(f"*{suffix}.csv"))}


def _prob(path):
    lines = path.read_text().splitlines()
    rows = np.array([[float(v) for v in line.split(",")]
                     for line in lines[1:]]).reshape(-1, 51)
    return lines[0], rows


def assert_probs_close(got_path, want_path):
    gh, g = _prob(got_path)
    wh, w = _prob(want_path)
    assert gh == wh and gh.startswith("roi,")
    np.testing.assert_array_equal(g[:, 0], w[:, 0])
    if len(g):
        np.testing.assert_array_equal(g[:, 1:].argmax(1), w[:, 1:].argmax(1))
        assert np.abs(g[:, 1:] - w[:, 1:]).max() <= QUANTUM_BOUND


def test_returns_the_samples_of_both_csvs(both_runs):
    written, jax_written, _, _ = both_runs
    assert written == jax_written == {FIXTURE.name, SEEDED, EMPTY}


def test_feat_csvs_byte_identical_to_jax(both_runs):
    _, _, mine, theirs = both_runs
    got, want = _csvs(mine, ".feat"), _csvs(theirs, ".feat")
    assert list(got) == list(want) and len(got) == 3
    for rel in got:
        assert got[rel].read_bytes() == want[rel].read_bytes(), rel
        assert got[rel].read_text().startswith("# version=tpu-v1\n")
    rows = {rel.name.split(".")[0]: len(p.read_text().splitlines()) - 3
            for rel, p in got.items()}
    assert rows == {FIXTURE.name: 2, SEEDED: 10, EMPTY: 0}


def test_prob_csvs_match_jax(both_runs):
    _, _, mine, theirs = both_runs
    got, want = _csvs(mine, ".prob"), _csvs(theirs, ".prob")
    assert list(got) == list(want) and len(got) == 3
    for rel in got:
        assert_probs_close(got[rel], want[rel])


def test_zero_roi_sample_is_flushed(both_runs):
    _, _, mine, _ = both_runs
    (prob,) = [p for p in _csvs(mine, ".prob").values()
               if p.name.startswith(EMPTY)]
    assert prob.read_text().count("\n") == 1  # the header alone


def test_failed_feature_job_keeps_prob_and_is_left_out(
        raw_dir, model_dir, tmp_path, monkeypatch):
    """One ROI's feature job raises (the wide one): that sample's prob CSV
    is written, its feat CSV is not, and it is left out of the returned
    set, in the port as in JAX."""
    def failing(real):
        def compute(img):
            if img.shape == WIDE:
                raise OSError("feature job failed")
            return real(img)
        return compute

    real = pipeline.compute_features
    monkeypatch.setattr(pipeline, "compute_features", failing(real))
    monkeypatch.setattr(jax_pipeline, "compute_features",
                        failing(jax_pipeline.compute_features))
    got = _port(raw_dir, model_dir, tmp_path / "port")
    want = _jax(raw_dir, model_dir, tmp_path / "jax")
    assert got == want == {FIXTURE.name, EMPTY}
    for root in (tmp_path / "port", tmp_path / "jax"):
        assert len(_csvs(root, ".prob")) == 3
        assert sorted(p.name for p in _csvs(root, ".feat").values()) == [
            f"{FIXTURE.name}.feat.csv", f"{EMPTY}.feat.csv"]
    # a rerun redoes the sample whose feat CSV is missing
    monkeypatch.setattr(pipeline, "compute_features", real)
    assert _port(raw_dir, model_dir, tmp_path / "port") == {SEEDED}


def test_two_gloo_ranks_equal_one(raw_dir, model_dir, both_runs, tmp_path):
    """``torchrun --nproc-per-node 2`` over the CLI on the CPU: rank 0
    decodes, runs the feature threads and writes; rank 1 follows."""
    _, _, one, _ = both_runs
    out = tmp_path / "two"
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "sykepic_tpu_torch", "pipeline",
         "-r", str(raw_dir), "-m", str(model_dir), "-o", str(out), "-b", "4",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)})
    assert run.returncode == 0, run.stderr[-3000:]
    got, want = _csvs(out, ".feat"), _csvs(one, ".feat")
    assert list(got) == list(want) and len(got) == 3
    for rel in got:
        assert got[rel].read_bytes() == want[rel].read_bytes()
    got, want = _csvs(out, ".prob"), _csvs(one, ".prob")
    assert list(got) == list(want)
    for rel in got:
        assert_probs_close(got[rel], want[rel])


def test_cuda_without_card_raises(raw_dir, model_dir, tmp_path):
    """``cuda`` is the default and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["pipeline", "-r", str(raw_dir), "-m", str(model_dir), "-o",
              str(tmp_path)])
    assert not list(tmp_path.rglob("*.csv"))
