"""The port's auxiliary host pieces held to ``tests/test_aux.py``,
``tests/test_device_data.py``, ``tests/test_analyze.py`` and
``tests/test_classification.py``: ``StageTimer``; the ``train_state.pt``
resume round trip; ``BatchLoader`` (a producer error reaching the consumer,
an abandoned iterator not hanging, size pooling, pre-shrink, stratified
batching), each batch equal to the JAX package's loader's for the same seed;
the gathered train step against the host-batch step; ``filter_csv_by_date``
and ``read_divisions`` against the JAX package's. Tolerance: exact equality,
except the train step (1e-6 relative on the loss: the same images reach the
network through two kernels' plain versions). The CSV sub-commands' exists
/ ``--append`` / ``--force`` rules are held in ``tests/test_torch_csv_tools.py``.

Every ``BatchLoader`` case runs its iteration on a thread joined with a
timeout, so a hang fails the case instead of the run."""

import threading

import numpy as np
import pytest
import torch

from sykepic_tpu.train import input as jinput
from sykepic_tpu_torch.train import input as tinput
from sykepic_tpu_torch.utils import png, profiling

BOUND_S = 60  # a loader case that takes longer has hung


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def bounded(fn, timeout=BOUND_S):
    """``fn()`` on a thread joined with a timeout: its result, or the
    exception it raised; fails if it is still running."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed back to the caller
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still running after {timeout} s: a hang"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("canvas", "heights", "widths", "labels", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert [str(p) for p in a.paths] == [str(p) for p in b.paths]


def _write(root, name, img):
    p = root / name
    png.write_png(p, img)
    return p


def test_stage_timer():
    timer = profiling.StageTimer(enabled=True)
    for name in ("a", "a", "b"):
        with timer.stage(name):
            pass
    assert timer.counts == {"a": 2, "b": 1}
    assert "a" in timer.summary() and "ms/call" in timer.summary()
    disabled = profiling.StageTimer(enabled=False)
    with disabled.stage("x"):
        pass
    assert not disabled.totals


def test_stage_timer_summary_equals_jax():
    from sykepic_tpu.utils import profiling as jprofiling

    timers = (profiling.StageTimer(enabled=True),
              jprofiling.StageTimer(enabled=True))
    for t in timers:
        t.totals.update({"decode": 1.25, "pack": 0.5, "drain": 3.0})
        t.counts.update({"decode": 10, "pack": 4, "drain": 7})
    assert timers[0].summary() == timers[1].summary()


def test_stage_timer_is_safe_across_threads():
    timer = profiling.StageTimer(enabled=True)

    def work():
        for _ in range(500):
            with timer.stage("s"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert timer.counts["s"] == 4000


def test_train_state_resume_roundtrip(tmp_path):
    from sykepic_tpu_torch.models import registry
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.input import HostBatch
    from sykepic_tpu_torch.train.loop import (load_train_state,
                                              save_train_state)
    from sykepic_tpu_torch.train.trainer import LRSchedule, Trainer

    spec = PreprocessSpec(32, 32, 3, border="black")

    def make_trainer(seed):
        model = registry.init_weights(
            registry.build_model("resnet18", 3, head=(8,)), seed)
        return Trainer(model, preprocess_spec=spec, device="cpu")

    t1 = make_trainer(0)
    rng = np.random.default_rng(0)
    batch = HostBatch(
        canvas=rng.integers(0, 255, (8, 32, 64), np.uint8),
        heights=np.full(8, 30, np.int32), widths=np.full(8, 20, np.int32),
        labels=np.arange(8, dtype=np.int32) % 3,
        weights=np.ones(8, np.float32), paths=[None] * 8)
    t1.train_batch(batch, stage=0, lrs=(1e-3, 0, 0))
    sched = LRSchedule(0.01, warmup=dict(factor_1=0.1, factor_2=0.5,
                                         step_1=1, step_2=2, step_3=3))
    sched.start_epoch(1)
    save_train_state(tmp_path, t1, epoch=5,
                     metrics={"max_val_acc": 0.9, "min_val_loss": 0.2,
                              "no_improvement": 1}, schedule=sched)

    t2 = make_trainer(1)
    state = load_train_state(tmp_path, t2)
    assert int(state["epoch"]) == 5
    assert state["metrics"]["max_val_acc"] == 0.9
    sched2 = LRSchedule(0.01)
    sched2.restore(state["schedule"])
    assert sched2.lrs == sched.lrs and sched2.stage == sched.stage
    from sykepic_tpu.train.trainer import LRSchedule as JaxLRSchedule

    jsched = JaxLRSchedule(0.01, warmup=dict(factor_1=0.1, factor_2=0.5,
                                             step_1=1, step_2=2, step_3=3))
    jsched.start_epoch(1)
    assert sched.snapshot() == jsched.snapshot()
    sd1, sd2 = t1.state_dict(), t2.state_dict()
    assert sd1.keys() == sd2.keys()
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
    opt1, opt2 = t1.optimizer_state(), t2.optimizer_state()
    assert opt1.keys() == opt2.keys()
    # the next step from the restored state equals the next step from t1
    r1 = [float(v) for v in t1.train_batch(batch, 0, (1e-3, 0, 0))]
    r2 = [float(v) for v in t2.train_batch(batch, 0, (1e-3, 0, 0))]
    assert r1 == r2
    assert load_train_state(tmp_path / "nope", t2) is None


def test_batchloader_producer_error_propagates(tmp_path):
    good = _write(tmp_path, "good.png", np.zeros((8, 8), np.uint8))
    loader = tinput.BatchLoader([good, tmp_path / "missing.png"], [0, 1],
                                batch_size=2)
    with pytest.raises(RuntimeError, match="producer failed"):
        bounded(lambda: list(loader))


def test_batchloader_abandoned_iterator_no_hang(tmp_path):
    paths = [_write(tmp_path, f"x{i}.png", np.full((8, 8), i, np.uint8))
             for i in range(64)]
    loader = tinput.BatchLoader(paths, list(range(64)), batch_size=4,
                                prefetch=1)

    def abandon_then_rerun():
        it = iter(loader)
        next(it)
        it.close()  # the consumer abandons mid-epoch
        return len(list(loader))  # a fresh epoch still works

    assert bounded(abandon_then_rerun) == 16


@pytest.fixture(scope="module")
def size_mix(tmp_path_factory):
    """56 small and 8 large images (the pooling case of tests/test_aux.py)."""
    root = tmp_path_factory.mktemp("sizes")
    rng = np.random.default_rng(0)
    paths = [_write(root, f"s{i}.png", rng.integers(0, 255, (20, 30),
                                                     np.uint8))
             for i in range(56)]
    paths += [_write(root, f"L{i}.png", rng.integers(0, 255, (150, 180),
                                                      np.uint8))
              for i in range(8)]
    return paths


@pytest.mark.parametrize("labels", ["one_class", "size_is_class"])
def test_batchloader_size_pooling_equals_jax(size_mix, labels):
    y = [0] * 64 if labels == "one_class" else [0] * 56 + [1] * 8
    kw = dict(batch_size=8, shuffle=True, seed=1, size_pool=8)
    got = bounded(lambda: list(tinput.BatchLoader(size_mix, y, **kw)))
    want = list(jinput.BatchLoader(size_mix, y, **kw))
    _assert_batches_equal(got, want)
    assert len(got) == 8  # every image exactly once
    if labels == "one_class":
        # size varies inside the class: most batches stay small-canvas
        assert sum(b.canvas.shape[1] <= 64 for b in got) >= 5
    else:
        # size is the class: every batch carries the class mix
        for b in got:
            assert set(b.labels[b.weights > 0].tolist()) == {0, 1}


def test_batchloader_pre_shrink_caps_canvas_as_jax(tmp_path):
    from sykepic_tpu_torch.ingest import pack

    p = _write(tmp_path, "big.png", np.random.default_rng(1).integers(
        0, 255, (600, 400), np.uint8))
    kw = dict(batch_size=4, pre_shrink_to=(180, 180))
    (batch,) = bounded(lambda: list(tinput.BatchLoader([p] * 4, [0] * 4,
                                                       **kw)))
    _assert_batches_equal([batch], list(jinput.BatchLoader([p] * 4, [0] * 4,
                                                           **kw)))
    assert batch.heights.max() <= 180 and batch.widths.max() <= 180
    h, w = int(batch.heights[0]), int(batch.widths[0])
    assert (h, w) == pack.target_resize_dims(h, w, 180, 180)


@pytest.fixture(scope="module")
def image_pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("pool")
    rng = np.random.default_rng(0)
    return [_write(root, f"i{i:03}.png", rng.integers(
        0, 255, (int(rng.integers(10, 120)), int(rng.integers(10, 120))),
        np.uint8)) for i in range(90)]


@pytest.mark.parametrize("trial", range(6))
def test_stratified_batching_equals_jax(image_pool, trial):
    """Every index once an epoch, no batch over batch_size, a class with
    at least n_batches members in all but at most one batch; each batch
    equal to the JAX package's loader's, two epochs running."""
    rng = np.random.default_rng([0, trial])
    n, b = int(rng.integers(17, 90)), int(rng.integers(4, 33))
    n_classes = int(rng.integers(2, 6))
    sub = [image_pool[int(k)] for k in rng.choice(90, n, replace=False)]
    labels = rng.integers(0, n_classes, n).tolist()
    kw = dict(batch_size=b, shuffle=True, seed=trial, size_pool=8)
    ours, theirs = tinput.BatchLoader(sub, labels, **kw), jinput.BatchLoader(
        sub, labels, **kw)
    n_batches = -(-n // b)
    counts = np.bincount(labels, minlength=n_classes)
    for _ in range(2):
        got = bounded(lambda: list(ours))
        _assert_batches_equal(got, list(theirs))
        assert len(got) == n_batches
        assert sum(int((g.weights > 0).sum()) for g in got) == n
        hits = np.zeros(n_classes, int)
        for g in got:
            assert len(g.weights) == b
            hits[sorted(set(g.labels[g.weights > 0].tolist()))] += 1
        for c in range(n_classes):
            if counts[c] >= n_batches:
                assert hits[c] >= n_batches - 1, (c, hits, counts)


def test_gathered_step_equals_host_batch_step(tmp_path):
    """``train_batch_gathered`` over rows of a device-resident store takes
    the same step as ``train_batch`` over a host batch of the same images
    (tests/test_device_data.py::test_gathered_step_matches_host_batch)."""
    from sykepic_tpu_torch.models import registry
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.device_data import DeviceDataset
    from sykepic_tpu_torch.train.input import HostBatch
    from sykepic_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(7)
    paths = [_write(tmp_path, f"g{i}.png", rng.integers(
        0, 255, (int(rng.integers(10, 30)), int(rng.integers(12, 30))),
        np.uint8)) for i in range(8)]
    labels = [i % 3 for i in range(8)]
    spec = PreprocessSpec(32, 32, 3, border="mode")
    ds = DeviceDataset(paths, labels, spec, batch_size=8, device="cpu")
    key, idx, weights = next(ds.epoch(shuffle=False))
    store = ds.stores[key]
    meta = store["meta"].numpy()
    canvas = np.zeros((len(idx), 32, 32), np.uint8)
    for i, row in enumerate(idx):
        h, w = int(meta[3, row]), int(meta[4, row])
        canvas[i, :h, :w] = store["canvas"][row, :h, :w].numpy()
    hb = HostBatch(canvas, meta[3, idx].astype(np.int32),
                   meta[4, idx].astype(np.int32),
                   store["labels"].numpy()[idx].astype(np.int32), weights,
                   [None] * len(idx))
    lrs = (1e-2, 0.0, 0.0)
    out = []
    for gathered in (False, True):
        model = registry.init_weights(
            registry.build_model("resnet18", 3, head=(16,)), 0)
        t = Trainer(model, optimizer="SGD", preprocess_spec=spec,
                    device="cpu")
        res = (t.train_batch_gathered(store, idx, weights, 0, lrs)
               if gathered else t.train_batch(hb, 0, lrs))
        out.append([float(v) for v in res])
    (l1, c1, n1), (l2, c2, n2) = out
    assert (c1, n1) == (c2, n2) == (c1, float(len(idx)))
    assert l2 == pytest.approx(l1, rel=1e-6)


def _prob_tree(root):
    """Three prob CSVs at three times of day (names carry the time)."""
    for name in ("D20180712T065600_IFCB114", "D20180712T103000_IFCB114",
                 "D20190101T000000_IFCB114"):
        d = root / name[1:5] / name[5:7] / name[7:9]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.prob.csv").write_text("roi,A\n1,1.00000\n")
    return root


@pytest.mark.parametrize("kw", [
    dict(), dict(hour_window="06:00-07:00"), dict(hour_window="10:00-11:00"),
    dict(start="2018-07-12 07:00"), dict(end="2018-12-31 00:00"),
    dict(start="2019-01-01 00:00", end="2019-01-01 00:00"),
    dict(start="2018/07/12", date_format="%Y/%m/%d")])
def test_filter_csv_by_date_equals_jax(tmp_path, kw):
    from sykepic_tpu.analyze import frequency as jfrequency
    from sykepic_tpu_torch.analyze import frequency

    root = _prob_tree(tmp_path)
    got = frequency.filter_csv_by_date(root, **kw)
    assert got == jfrequency.filter_csv_by_date(root, **kw)
    if kw == dict(hour_window="06:00-07:00"):
        assert len(got) == 1


def test_filter_csv_by_date_needs_a_directory(tmp_path):
    from sykepic_tpu_torch.analyze import frequency

    with pytest.raises(FileNotFoundError):
        frequency.filter_csv_by_date(tmp_path / "none")


@pytest.mark.parametrize("text", [
    "Aphanizomenon_flosaquae 5000 9000\n",
    "A 1 2 3\nB 10\n\nC 0.5 7\n",
    "# comment\nA 5000\n"])
def test_read_divisions_equals_jax(tmp_path, text):
    from sykepic_tpu.compute import classification as jclassification
    from sykepic_tpu_torch.compute import classification

    path = tmp_path / "divisions.txt"
    path.write_text(text)

    def outcome(module):
        try:
            return module.read_divisions(path)
        except ValueError as e:
            return type(e)

    got = outcome(classification)
    assert got == outcome(jclassification)
    if text.startswith("Aph"):
        assert got == {"Aphanizomenon_flosaquae": [5000, 9000]}
