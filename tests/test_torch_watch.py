"""The port's ``watch`` daemon (``sykepic_tpu_torch/compute/watch.py``)
through the six behaviours of ``tests/test_watch.py``, with the port's
``Classifier`` on the CPU over the conftest's ``model_dir``: the settle
filter, each sample processed once, a transient feature failure retried, an
oversized ``.roi`` skipped for good, a permanent failure given up after
``max_retries``, and a cycle in which every sample fails (systemic) burning
no retries. Then the CLI: one classifier on ``--device`` without a mesh,
and ``cuda`` without a card raises. The classifier packs slots
(``SYKEPIC_PACKING=slots``): at batch 4 a CPU dispatch is 4 slots where a
shelf dispatch is 64, and the daemon's behaviours do not depend on it.
"""

import os
import shutil
import time
from pathlib import Path

import pytest
import torch

from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.compute import pipeline, probability, watch

SRC = Path("tests/data/raw/valid")
SAMPLE = "D20180712T065600_IFCB114"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clf(model_dir):
    with pytest.MonkeyPatch.context() as m:
        m.setenv("SYKEPIC_PACKING", "slots")
        return probability.prepare_model(model_dir, batch_size=4,
                                         device="cpu")


def copy_sample(raw_dir, old=True):
    raw_dir.mkdir(parents=True, exist_ok=True)
    for f in SRC.iterdir():
        dst = raw_dir / f.name
        shutil.copy(f, dst)
        if old:  # make the sample look settled
            past = time.time() - 3600
            os.utime(dst, (past, past))


def test_settle_filter(tmp_path):
    raw = tmp_path / "raw"
    copy_sample(raw, old=False)  # just written -> not ready
    assert watch.find_ready_samples(raw, settle_seconds=60) == []
    copy_sample(raw, old=True)
    ready = watch.find_ready_samples(raw, settle_seconds=60)
    assert [p.name for p in ready] == [SAMPLE]


def test_watch_processes_new_samples_once(tmp_path, clf):
    raw = tmp_path / "raw"
    copy_sample(raw, old=True)
    sleeps = []
    done = watch.run(
        raw, clf, tmp_path / "out", interval=0.0, settle_seconds=1,
        max_cycles=3, sleep=sleeps.append,
    )
    assert done == {SAMPLE}
    prob_csvs = list((tmp_path / "out").glob("**/*.prob.csv"))
    feat_csvs = list((tmp_path / "out").glob("**/*.feat.csv"))
    assert len(prob_csvs) == 1 and len(feat_csvs) == 1
    assert feat_csvs[0].read_text().startswith("# version=tpu-v1\n")
    assert len(sleeps) == 2  # slept between cycles, not after the last
    mtime = prob_csvs[0].stat().st_mtime_ns

    # a second run over the same tree reprocesses nothing
    done2 = watch.run(
        raw, clf, tmp_path / "out", interval=0.0, settle_seconds=1,
        max_cycles=1, sleep=lambda s: None,
    )
    assert prob_csvs[0].stat().st_mtime_ns == mtime
    assert done2 == {SAMPLE}  # seen again, skipped via existing CSVs


def test_watch_retries_failed_feature_extraction(tmp_path, clf, monkeypatch):
    """A sample whose feature extraction fails transiently is retried on
    the next cycle (only prob+feat success marks it done)."""
    raw = tmp_path / "raw"
    copy_sample(raw, old=True)
    calls = {"n": 0}
    real_compute = pipeline.compute_features

    def flaky(img):
        if calls["n"] == 0:
            calls["n"] += 1
            raise OSError("transient")
        return real_compute(img)

    monkeypatch.setattr(pipeline, "compute_features", flaky)
    out = tmp_path / "out"
    done = watch.run(
        raw, clf, out, interval=0.0, settle_seconds=1,
        max_cycles=3, sleep=lambda s: None,
    )
    assert done == {SAMPLE}
    assert list(out.glob("**/*.feat.csv"))
    assert list(out.glob("**/*.prob.csv"))


def test_watch_skips_oversized_roi_for_good(tmp_path, clf, monkeypatch):
    raw = tmp_path / "raw"
    copy_sample(raw, old=True)
    monkeypatch.setattr(probability, "MAX_ROI_BYTES", 10)  # all "big"
    out = tmp_path / "out"
    done = watch.run(
        raw, clf, out, interval=0.0, settle_seconds=1,
        max_cycles=2, sleep=lambda s: None,
    )
    assert done == {SAMPLE}  # marked done (skipped), never decoded
    assert not list(out.glob("**/*.csv"))


def test_watch_gives_up_on_permanent_failures(tmp_path, clf, monkeypatch):
    """A sample that fails every cycle (corrupt data) is abandoned after
    max_retries instead of being re-decoded for the daemon's lifetime."""
    raw = tmp_path / "raw"
    copy_sample(raw, old=True)
    calls = {"n": 0}

    def always_fails(img):
        calls["n"] += 1
        raise ValueError("corrupt")

    monkeypatch.setattr(pipeline, "compute_features", always_fails)
    out = tmp_path / "out"
    done = watch.run(
        raw, clf, out, interval=0.0, settle_seconds=1,
        max_cycles=6, max_retries=2, sleep=lambda s: None,
    )
    # abandoned (in done) despite never producing a feat CSV...
    assert done == {SAMPLE}
    assert not list(out.glob("**/*.feat.csv"))
    # ...and attempts stopped at max_retries, not max_cycles
    attempts = calls["n"]
    assert attempts > 0
    calls["n"] = 0
    watch.run(raw, clf, out, interval=0.0, settle_seconds=1,
              max_cycles=6, max_retries=6, sleep=lambda s: None)
    assert calls["n"] > attempts  # more retries allowed -> more attempts


def test_watch_systemic_failures_do_not_burn_retries(tmp_path, clf,
                                                     monkeypatch):
    """A cycle in which EVERY attempted sample fails looks like an outage,
    not per-sample corruption: it counts toward no retry budget, and the
    samples process once the fault clears."""
    raw = tmp_path / "raw"
    copy_sample(raw, old=True)
    past = time.time() - 3600
    for f in SRC.iterdir():
        dst = raw / f.name.replace("T065600", "T070000")
        shutil.copy(f, dst)
        os.utime(dst, (past, past))
    broken = {"on": True}
    real_compute = pipeline.compute_features

    def outage(img):
        if broken["on"]:
            raise OSError("no space left on device")
        return real_compute(img)

    monkeypatch.setattr(pipeline, "compute_features", outage)
    out = tmp_path / "out"
    done = watch.run(raw, clf, out, interval=0.0, settle_seconds=1,
                     max_cycles=5, max_retries=2, sleep=lambda s: None)
    assert done == set()  # still pending, NOT abandoned
    broken["on"] = False
    done = watch.run(raw, clf, out, interval=0.0, settle_seconds=1,
                     max_cycles=2, max_retries=2, sleep=lambda s: None)
    assert done == {SAMPLE, SAMPLE.replace("T065600", "T070000")}
    assert len(list(out.glob("**/*.feat.csv"))) == 2


def test_watch_cli_builds_one_classifier(tmp_path, model_dir, monkeypatch):
    seen = {}

    def record(raw, clf, out, **kw):
        seen.update(raw=raw, clf=clf, out=out, **kw)

    monkeypatch.setattr(watch, "run", record)
    main(["watch", "-r", str(tmp_path), "-m", str(model_dir), "-o",
          str(tmp_path / "out"), "-b", "8", "-i", "5", "--settle", "7",
          "--device", "cpu"])
    assert seen["clf"].device == torch.device("cpu")
    assert seen["clf"].mesh is None and seen["clf"].batch_size == 8
    assert (seen["interval"], seen["settle_seconds"]) == (5.0, 7.0)
    assert seen["feat_out_dir"] == str(tmp_path / "out")
    assert seen["max_cycles"] is None


def test_watch_cli_cuda_without_card_raises(tmp_path, model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["watch", "-r", str(tmp_path), "-m", str(model_dir), "-o",
              str(tmp_path / "out")])
