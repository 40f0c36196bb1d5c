"""Each cell's check, driven as a run drives it, with the timed path broken
underneath: ``correct`` has to come out false. And unbroken, true."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import gen, harness
from bench_port.tests.tiny import SEED, run_tiny, staged_bench, tiny_plan

PROB = ["resnet18.prob.archive", "efficientnet_b0.prob.archive"]
TRAIN = ["resnet18.train.steady"]
BENCH = staged_bench()
BENCH_CELLS = {w["name"] for w in BENCH["workloads"]}


def _cells(names):
    return [c for c in names if c in BENCH_CELLS]


@pytest.mark.parametrize("cell", _cells(PROB + TRAIN))
def test_unbroken_run_is_correct(cell):
    result = run_tiny(tiny_plan(cell))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def _answers_altered(monkeypatch):
    """The temperature of the softmax, where probabilities are made, off by
    under one percent."""
    from sykepic_tpu_torch.compute import engine

    monkeypatch.setattr(engine, "SOFTMAX_EXP", 1.302)


def _pixels_moved(monkeypatch):
    """K1's output shifted by one column."""
    from sykepic_tpu_torch.ops import preprocess

    real = preprocess.eval_preprocess_meta

    def moved(*args, **kwargs):
        return torch.roll(real(*args, **kwargs), 1, dims=2)

    monkeypatch.setattr(preprocess, "eval_preprocess_meta", moved)


def _half_the_rows(monkeypatch):
    """Every dispatch drains half of its rows."""
    from sykepic_tpu_torch.compute import engine

    real = engine.Classifier._drain_block

    def half(self, batch, host_rows, event):
        sidx, rids, probs = real(self, batch, host_rows, event)
        keep = len(rids) // 2
        return sidx[:keep], rids[:keep], probs[:keep]

    monkeypatch.setattr(engine.Classifier, "_drain_block", half)


@pytest.mark.parametrize("fault", [_answers_altered, _pixels_moved,
                                   _half_the_rows])
@pytest.mark.parametrize("cell", _cells(PROB))
def test_prob_faults_fail(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(tiny_plan(cell))["correct"]


def _state_unchanged(monkeypatch):
    """Steps that leave the parameters as they were."""
    from sykepic_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Optimizer, "update",
                        lambda self, grads, state, params: [
                            torch.zeros_like(g) for g in grads])


def _half_the_batch(monkeypatch):
    """Half of every part of a batch left out, the loss their mean."""
    from sykepic_tpu_torch.train import trainer

    path_mod = harness.load_module(harness.HERE / "paths" / "train.py")
    real = trainer.Trainer.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        path_mod.half_batch(self)

    monkeypatch.setattr(trainer.Trainer, "__init__", init)


def _labels_altered(monkeypatch):
    """The labels of a batch shifted by one class where K1's step reads
    them."""
    from sykepic_tpu_torch.train import trainer

    real = trainer.Trainer._preprocess

    def shifted(self, parts, train):
        x, y, rows = real(self, parts, train)
        return x, (y + 1) % 50, rows

    monkeypatch.setattr(trainer.Trainer, "_preprocess", shifted)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _labels_altered])
@pytest.mark.parametrize("cell", _cells(TRAIN))
def test_train_faults_fail(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny(tiny_plan(cell))
    assert not result["correct"], result["checks"]


def test_leaf_gaps_floor_and_keep():
    path_mod = harness.load_module(harness.HERE / "paths" / "train.py")
    ref = {"a": 1.0, "b": 0.5, "c": 4.0, "tiny": 1e-6}
    seen = {"a": 1.1, "b": 0.5, "c": 4.0, "tiny": 2e-6}
    # "tiny" is measured against the median leaf, not itself
    assert path_mod.leaf_gaps(seen, ref) == pytest.approx([0.1, 0, 0, 1e-6 / 0.75])
    assert path_mod.leaf_gaps(seen, ref, keep={"b", "c"}).max() == 0.0


def test_row_images_maps_every_row(tmp_path):
    """Each store row of the port's dataset maps to the image whose pixels
    and label it holds, and every image to one row (at the cell's input
    size, where the set spans several buckets)."""
    from sykepic_tpu_torch.ingest import pack
    from sykepic_tpu_torch.train import config as tcfg
    from sykepic_tpu_torch.train.device_data import DeviceDataset

    path_mod = harness.load_module(harness.HERE / "paths" / "train.py")
    plan = harness.cell_plan(BENCH, "resnet18.train.steady")
    plan["traffic"]["set"].update(images=300)
    target = plan["cfg"]["image_shape"][1]
    images, labels = gen.build_train_set(plan["traffic"]["set"], SEED)
    paths = gen.write_train_set(tmp_path / "set", images)
    model_dir = gen.write_model_dir(tmp_path / "model", plan["cfg"], None)
    spec = tcfg.get_preprocess_spec(tcfg.read_config(model_dir / "config.ini"))
    data = DeviceDataset(paths, labels, spec, batch_size=64, seed=SEED,
                         shuffle=True)
    rows = path_mod.row_images(data)
    assert len(rows) == len(data.stores) > 1
    mapped = []
    for store in data.stores.values():
        canvas, held = store["canvas"].numpy(), store["labels"].numpy()
        for j, i in enumerate(rows[id(store)]):
            if i < 0:
                continue
            want = pack.pre_shrink(images[i], target, target)
            h, w = want.shape
            assert np.array_equal(canvas[j, :h, :w], want)
            assert held[j] == labels[i]
            mapped.append(i)
    assert sorted(mapped) == list(range(len(images)))
