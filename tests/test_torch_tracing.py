"""The port's ``StageTimer`` as its recorder of spans and counters.

An enabled timer's span is also a host op of ``torch.profiler`` (not a
user annotation, which the profiler would copy onto the device's
timeline), so it lands in the profiler's trace on the clock of the ops it
encloses; a disabled one records nothing. Counters sum into ``totals`` and print apart from the
stages. ``SYKEPIC_PROFILE`` is read when a timer is built.

On a tiny ``process_samples_batched`` run (a ResNet18 at 32x32 on the
fixture sample, copied under a second name, and a zero-ROI sample) the
``prob`` path's spans and counters hold what they claim: one
``prob.csv_write`` per CSV written, ``engine.rois`` the ROIs decoded,
``engine.slots`` the slots of the dispatches made, padding included, and
``engine.wait_input`` and ``prob.job_close`` on the calling thread, inside
the job's own span ``prob.job``, where the profiler sees them.
"""

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sykepic_tpu_torch.compute import probability
from sykepic_tpu_torch.ingest import ifcb, pack
from sykepic_tpu_torch.models import checkpoint
from sykepic_tpu_torch.train import config as tcfg
from sykepic_tpu_torch.utils import profiling

FIXTURE = Path("tests/data/raw/valid/D20180712T065600_IFCB114")
SAMPLES = ("D20180712T065600_IFCB114", "D20180712T070000_IFCB114")
EMPTY = "D20180712T080000_IFCB114"
TINY = 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _events(prof):
    """``(name, start_ns, end_ns)`` of every event the profiler kept."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            out.append((e.name(), e.start_ns(), e.end_ns()))
        else:
            start = int(e.start_us() * 1000)
            out.append((e.name(), start, start + int(e.duration_us() * 1000)))
    return out


def test_span_sits_on_the_profilers_clock():
    timer = profiling.StageTimer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("test.span"):
            torch.ones(64).mul_(3)
    events = _events(prof)
    (span,) = [e for e in events if e[0] == "test.span"]
    (op,) = [e for e in events if e[0] == "aten::mul_"]
    assert span[1] <= op[1] <= op[2] <= span[2]
    assert timer.counts["test.span"] == 1 and timer.totals["test.span"] > 0


def test_span_is_a_host_op_not_a_user_annotation():
    # a user annotation is copied onto the device's timeline over the
    # kernels launched inside it, where it would read as device work
    timer = profiling.StageTimer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("test.host"):
            torch.ones(64).mul_(3)
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "test.host"]
    assert not event.is_user_annotation()
    assert event.device_type() == torch.autograd.DeviceType.CPU


def test_disabled_timer_records_nothing():
    timer = profiling.StageTimer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("test.off"):
            torch.ones(64).mul_(3)
        timer.count("test.count", 5)
    assert "test.off" not in {e[0] for e in _events(prof)}
    assert not timer.totals and not timer.counts and not timer.counters


def test_span_closes_when_its_body_raises():
    timer = profiling.StageTimer(enabled=True)
    with pytest.raises(ValueError):
        with timer.stage("test.raise"):
            raise ValueError("out")
    assert timer.counts["test.raise"] == 1


def test_counters_add_up_in_totals():
    timer = profiling.StageTimer(enabled=True)
    timer.count("slots", 256)
    timer.count("slots", 512)
    timer.count("encoded")
    assert timer.totals["slots"] == 768 and timer.totals["encoded"] == 1
    assert timer.counts["slots"] == 2
    assert timer.counters == {"slots", "encoded"}


def test_counters_print_in_their_own_section():
    from sykepic_tpu.utils import profiling as jprofiling

    timer = profiling.StageTimer(enabled=True)
    jtimer = jprofiling.StageTimer(enabled=True)
    for t in (timer, jtimer):
        t.totals.update({"decode": 1.25, "drain": 3.0})
        t.counts.update({"decode": 10, "drain": 7})
    timer.count("engine.slots", 2048)
    timer.count("engine.rois", 1900)
    lines = timer.summary().splitlines()
    head = lines.index("counter                          total   calls")
    # the stage table is the JAX package's, byte for byte
    assert "\n".join(lines[:head]) == jtimer.summary()
    assert lines[head + 1:] == [f"{'engine.rois':<30} {1900:8d} {1:7d}",
                                f"{'engine.slots':<30} {2048:8d} {1:7d}"]


@pytest.mark.parametrize("value, enabled",
                         [("1", True), ("0", False), (None, False)])
def test_profile_switch_is_read_when_a_timer_is_built(monkeypatch, value,
                                                      enabled):
    if value is None:
        monkeypatch.delenv("SYKEPIC_PROFILE", raising=False)
    else:
        monkeypatch.setenv("SYKEPIC_PROFILE", value)
    assert profiling.StageTimer().enabled is enabled
    assert profiling.StageTimer(enabled=not enabled).enabled is not enabled


def test_device_trace_holds_every_threads_spans(tmp_path):
    timer = profiling.StageTimer(enabled=True)

    def writer():
        with timer.stage("test.thread"):
            torch.ones(8).add_(1)

    with profiling.device_trace(tmp_path):
        with timer.stage("test.main"):
            thread = threading.Thread(target=writer)
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"test.main", "test.thread"} <= names


# -- the prob path, tiny ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    """A ResNet18 model directory at 3x32x32 with seeded weights."""
    src = Path("tests/model/resnet18_ref")
    d = tmp_path_factory.mktemp("tiny_model")
    (d / "config.ini").write_text((src / "config.ini").read_text().replace(
        "shape = 3, 180, 180", f"shape = 3, {TINY}, {TINY}"))
    shutil.copy(src / "class_names.txt", d / "class_names.txt")
    torch.manual_seed(0)
    model, _ = tcfg.get_network(tcfg.read_config(d / "config.ini"), 50)
    checkpoint.save_variables(d / "best_state.msgpack",
                              checkpoint.to_flax_variables(
                                  model.state_dict(), model.network))
    return d


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """The fixture sample under two names, and a sample of empty
    triggers only."""
    raw = tmp_path_factory.mktemp("raw")
    for name in SAMPLES:
        for ext in ("adc", "roi", "hdr"):
            shutil.copy(FIXTURE.with_suffix(f".{ext}"), raw / f"{name}.{ext}")
    (raw / f"{EMPTY}.adc").write_text(
        "\n".join(",".join(["0"] * 24) for _ in range(3)) + "\n")
    (raw / f"{EMPTY}.roi").write_bytes(b"")
    (raw / f"{EMPTY}.hdr").write_text("runTime: 60\ninhibitTime: 1\n")
    return raw


@pytest.fixture(scope="module", params=["shelf"])
def prob_run(request, tiny_model, raw_dir, tmp_path_factory):
    """One profiled ``process_samples_batched`` job with an enabled timer;
    the slot count of every shelf dispatch is recorded as it is made."""
    clf = probability.prepare_model(tiny_model, batch_size=2, device="cpu")
    clf.timer = profiling.StageTimer(enabled=True)
    dispatched = []
    inner = clf.dispatch_shelf

    def recording(batch, meta=None):
        dispatched.append((batch.n_valid, meta.shape[1]))
        return inner(batch, meta)

    clf.dispatch_shelf = recording
    samples = [raw_dir / s for s in (*SAMPLES, EMPTY)]
    out = tmp_path_factory.mktemp(f"out_{request.param}")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        written = probability.process_samples_batched(samples, clf, out,
                                                      force=True)
    return {"timer": clf.timer, "dispatched": dispatched,
            "written": written, "samples": samples, "out": out,
            "events": _events(prof)}


def test_csv_write_once_per_written_sample(prob_run):
    assert prob_run["written"] == {*SAMPLES, EMPTY}
    assert len(list(prob_run["out"].rglob("*.prob.csv"))) == 3
    assert prob_run["timer"].counts["prob.csv_write"] == 3


def test_engine_rois_are_the_rois_decoded(prob_run):
    decoded = sum(len(ifcb.read_sample(s)) for s in prob_run["samples"])
    assert decoded == 4  # two per copy of the fixture: ROI 1 is empty
    assert prob_run["timer"].totals["engine.rois"] == decoded
    assert sum(n for n, _ in prob_run["dispatched"]) == decoded


def test_engine_slots_are_the_slots_dispatched(prob_run):
    dispatched = prob_run["dispatched"]
    timer = prob_run["timer"]
    assert timer.totals["engine.slots"] == sum(r for _, r in dispatched)
    assert timer.counts["engine.slots"] == len(dispatched)
    assert all(r >= n for n, r in dispatched)
    # the padding is counted: the shelf pads to its 64-slot floor
    assert timer.totals["engine.slots"] == 64 > timer.totals["engine.rois"]


def test_input_wait_and_job_close_reach_the_profiler(prob_run):
    timer = prob_run["timer"]
    # one wait per batch taken, and one for the stream's end
    assert timer.counts["engine.wait_input"] == len(prob_run["dispatched"]) + 1
    assert timer.counts["prob.job_close"] == timer.counts["prob.job"] == 1
    events = prob_run["events"]
    names = [e[0] for e in events]
    waits = timer.counts["engine.wait_input"]
    assert names.count("engine.wait_input") == waits
    # the job's span holds every other span of the calling thread
    (job,) = [e for e in events if e[0] == "prob.job"]
    inner = [e for e in events
             if e[0] in ("engine.wait_input", "prob.job_close",
                         "device.dispatch")]
    assert len(inner) == waits + 1 + len(prob_run["dispatched"])
    assert all(job[1] <= e[1] <= e[2] <= job[2] for e in inner)
    assert "engine.rois" not in timer.summary().split("counter")[0]


def test_fused_stream_counts_its_dispatches(tiny_model):
    clf = probability.prepare_model(tiny_model, batch_size=2, device="cpu")
    clf.timer = profiling.StageTimer(enabled=True)
    rois = ifcb.read_sample(FIXTURE)
    block = pack.RoiBlock(sample_idx=0, roi_ids=rois.roi_ids,
                          heights=rois.heights, widths=rois.widths,
                          offsets=rois.starts, base=rois.roi_data)
    got = list(clf.classify_and_feature_rois([block]))
    assert sorted(r for _, r, _, _ in got) == rois.roi_ids.tolist()
    timer = clf.timer
    assert timer.totals["engine.rois"] == len(rois) == 2
    slots = timer.totals["engine.slots"]
    assert slots >= len(rois) and slots % 2 == 0
    assert np.isfinite([p for _, _, p, _ in got]).all()
