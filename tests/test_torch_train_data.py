"""The port's training data layer (``sykepic_tpu_torch/train/data.py``)
against the JAX package's (``sykepic_tpu/train/data.py``), on
``tests/test_train_data.py``'s datasets: for the same files and seed, the
split membership and order, labels, oversampling, artifacts and file
listings are equal."""

import cv2
import numpy as np
import pytest

from sykepic_tpu.train import data as jax_data
from sykepic_tpu_torch.train import data


def make_dataset(root, classes):
    rng = np.random.default_rng(0)
    for name, count in classes.items():
        d = root / name
        d.mkdir(parents=True)
        for i in range(count):
            img = rng.integers(0, 255, (12 + i % 5, 9 + i % 7), np.uint8)
            cv2.imwrite(str(d / f"{name}_{i:03}.png"), img)


CASES = [
    ({"A": 20, "B": 10, "C": 5}, (0.6, 0.2, 0.2), {}, 24, None),
    ({"A": 10}, (0.7, 0.3), {}, 7, None),
    ({"Zebra": 4, "Alga": 4}, (0.5, 0.5), {}, 24, None),
    ({"A": 12, "B": 4}, (0.5, 0.5), {}, 24, (10, None)),
    ({"A": 30, "B": 9, "skip": 6}, (0.6, 0.2, 0.2),
     dict(min_N=5, max_N=20, exclude=["skip"]), 3, (None, 0.9)),
]


@pytest.mark.parametrize("classes,split,kw,seed,over", CASES)
def test_split_membership_equals_jax(tmp_path, classes, split, kw, seed,
                                     over):
    make_dataset(tmp_path / "ds", classes)
    args = (tmp_path / "ds", split, kw.get("min_N"), kw.get("max_N"),
            kw.get("exclude", ()), seed)
    port, ref = data.ModelData(*args), jax_data.ModelData(*args)
    assert port.train_x == ref.train_x
    assert port.val_x == ref.val_x
    assert port.test_x == ref.test_x
    assert list(port.le.classes_) == list(ref.le.classes_)
    assert [int(y) for y in port.train_y] == [int(y) for y in ref.train_y]
    assert [int(y) for y in port.val_y] == [int(y) for y in ref.val_y]
    if over is not None:
        port.oversample(*over)
        ref.oversample(*over)
    px, py = port.train_set()
    rx, ry = ref.train_set()
    assert px == rx and [int(y) for y in py] == [int(y) for y in ry]
    assert port.distribution == ref.distribution
    port.save(tmp_path / "port")
    ref.save(tmp_path / "ref")
    for f in ("class_distribution.csv", "class_names.txt"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes()


def test_listing_helpers_equal_jax(tmp_path):
    make_dataset(tmp_path / "ds", {"A": 10, "B": 2, "Unclassified": 5})
    for kw in (dict(min_N=3), dict(max_N=4), dict(exclude=["B"])):
        assert list(data.list_files(tmp_path / "ds", ".png", **kw)) == \
            list(jax_data.list_files(tmp_path / "ds", ".png", **kw))
    md = data.ModelData(tmp_path / "ds", (0.5, 0.5), 3, None,
                        ["Unclassified"], 24)
    jmd = jax_data.ModelData(tmp_path / "ds", (0.5, 0.5), 3, None,
                             ["Unclassified"], 24)
    make_dataset(tmp_path / "ext", {"A": 6})
    x, y = data.external_eval_set(tmp_path / "ext", md)
    jx, jy = jax_data.external_eval_set(tmp_path / "ext", jmd)
    assert x == jx and [int(v) for v in y] == [int(v) for v in jy]
    assert data.oversample(list("abc"), [0, 0, 0], None, 0.9) == \
        jax_data.oversample(list("abc"), [0, 0, 0], None, 0.9)
    (tmp_path / "m" / "resnet18_3").mkdir(parents=True)
    assert data.auto_id("resnet18", tmp_path / "m") == \
        jax_data.auto_id("resnet18", tmp_path / "m") == 4


@pytest.mark.parametrize("kw", [dict(min_N=3, exclude=("skip",)),
                                dict(max_N=4, random_seed=7), {}])
def test_create_dataset_equals_jax(tmp_path, kw):
    from sykepic_tpu.train import dataset as jax_dataset
    from sykepic_tpu_torch.train import dataset

    make_dataset(tmp_path / "src", {"A": 6, "B": 2, "skip": 3})
    port = dataset.create_dataset(tmp_path / "src", tmp_path / "port", **kw)
    ref = jax_dataset.create_dataset(tmp_path / "src", tmp_path / "ref", **kw)
    assert port == ref
    for name in ref:
        files = sorted(p.name for p in (tmp_path / "ref" / name).iterdir())
        assert sorted(p.name for p in (tmp_path / "port" / name).iterdir()) \
            == files
        for f in files:
            assert (tmp_path / "port" / name / f).read_bytes() == \
                (tmp_path / "ref" / name / f).read_bytes()
