"""The port's device-resident dataset (``sykepic_tpu_torch/train/
device_data.py``) against the JAX package's (``sykepic_tpu/train/
device_data.py``): for the same files and seed the index plans of
``epoch``, ``epoch_mixed`` and ``epoch_mixed_stacked`` are equal row for
row, epoch after epoch; every occurrence appears once; duplicates share
rows; ``estimate_nbytes`` and ``nbytes`` equal the JAX package's; the
stores hold K1's slot metadata with the store row as window index; and a
mixed step equals a host-batch step on the same images, in the port and
against the JAX package's mixed step."""

import cv2
import jax
import numpy as np
import pytest
import torch

from sykepic_tpu.models.registry import build_model as jax_build
from sykepic_tpu.models.registry import init_variables
from sykepic_tpu.train import device_data as jax_dd
from sykepic_tpu.train.config import PreprocessSpec as JaxSpec
from sykepic_tpu.train.trainer import Trainer as JaxTrainer
from sykepic_tpu_torch.models import checkpoint, registry
from sykepic_tpu_torch.train import device_data as dd
from sykepic_tpu_torch.train.config import PreprocessSpec
from sykepic_tpu_torch.train.input import HostBatch
from sykepic_tpu_torch.train.trainer import Trainer

TWO = ((24, 40), (64, 64))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("devdata")
    rng = np.random.default_rng(7)
    paths, labels = [], []
    for i in range(23):
        h, w = int(rng.integers(10, 40)), int(rng.integers(12, 60))
        p = root / f"img_{i:03}.png"
        cv2.imwrite(str(p), rng.integers(0, 255, (h, w), np.uint8))
        paths.append(p)
        labels.append(i % 3)
    # oversample: the first 5 files again (shared store rows)
    return paths + paths[:5], labels + labels[:5]


def _pair(dataset_dir, **kw):
    paths, labels = dataset_dir
    args = (paths, labels)
    port = dd.DeviceDataset(*args, PreprocessSpec(32, 32, 3, "black"),
                            device="cpu", **kw)
    jax_ds = jax_dd.DeviceDataset(*args, JaxSpec(32, 32, 3, "black"), **kw)
    return port, jax_ds


@pytest.mark.parametrize("kw", [
    dict(batch_size=8, seed=1), dict(batch_size=8, seed=2, buckets=TWO),
    dict(batch_size=5, seed=3, batch_multiple=3),
    dict(batch_size=8, seed=4, buckets=((16, 16), (32, 32), (64, 64)))])
def test_epoch_plans_equal_jax(dataset_dir, kw):
    port, jax_ds = _pair(dataset_dir, shuffle=True, **kw)
    assert port._bucket_keys == jax_ds._bucket_keys
    assert len(port) == len(jax_ds)
    for _ in range(3):  # the rng advances the same way, epoch after epoch
        for (k1, i1, w1), (k2, i2, w2) in zip(port.epoch(True),
                                              jax_ds.epoch(True), strict=True):
            assert k1 == k2
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(w1, w2)
        for (k1, i1, w1), (k2, i2, w2) in zip(port.epoch_mixed(True),
                                              jax_ds.epoch_mixed(True),
                                              strict=True):
            assert k1 == k2
            for a, b in zip(i1, i2, strict=True):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(w1, w2)
        a, b = port.epoch_mixed_stacked(True), jax_ds.epoch_mixed_stacked(True)
        for x, y in zip(a[1], b[1], strict=True):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[2], b[2])


def test_unshuffled_plans_and_labels_equal_jax(dataset_dir):
    port, jax_ds = _pair(dataset_dir, batch_size=8)
    for b1, b2 in zip(port, jax_ds, strict=True):
        np.testing.assert_array_equal(b1.idx, b2.idx)
        np.testing.assert_array_equal(b1.labels, b2.labels)
        np.testing.assert_array_equal(
            b1.store["labels"].index_select(0, torch.from_numpy(
                b1.idx).long()).numpy(), b1.labels)


def test_every_occurrence_once_and_rows_shared(dataset_dir):
    paths, _ = dataset_dir
    port, _ = _pair(dataset_dir, batch_size=8, seed=1, shuffle=True,
                    buckets=TWO)
    assert port.num_samples == len(paths) and port.num_rows == 23
    assert port._use_mixed
    seen = 0.0
    comp = None
    for b in port:
        sizes = tuple(len(i) for i in b.idxs)
        comp = comp or sizes
        assert sizes == comp
        seen += float(b.weights.sum())
        for store, idx in zip(b.stores, b.idxs):
            assert idx.max() < store["canvas"].shape[0]
    assert seen == len(paths)
    total = sum(float(w.sum()) for _, _, w in port.epoch())
    assert total == len(paths)


def test_estimate_and_nbytes_equal_jax(dataset_dir):
    paths, _ = dataset_dir
    port, jax_ds = _pair(dataset_dir, batch_size=8)
    est = dd.estimate_nbytes(paths, PreprocessSpec(32, 32, 3, "black"))
    assert est == jax_dd.estimate_nbytes(paths, JaxSpec(32, 32, 3, "black"))
    assert est == port.nbytes == jax_ds.nbytes


def test_stores_hold_k1_slot_rows(dataset_dir):
    port, jax_ds = _pair(dataset_dir, batch_size=8, buckets=TWO)
    for key, store in port.stores.items():
        host = {k: np.asarray(v) for k, v in jax_ds.stores[key].items()}
        n = len(host["heights"])
        assert store["canvas"].dtype == torch.uint8
        np.testing.assert_array_equal(store["canvas"].numpy(),
                                      host["canvas"])
        meta = store["meta"].numpy()
        assert meta.dtype == np.int32 and meta.shape == (10, n)
        np.testing.assert_array_equal(meta[0], np.arange(n))
        assert not meta[1:3].any()
        for row, f in enumerate(("heights", "widths", "new_h", "new_w",
                                 "pad_top", "pad_left", "border"), start=3):
            np.testing.assert_array_equal(meta[row], host[f])
        np.testing.assert_array_equal(store["lim"].numpy(),
                                      np.stack([host["lim_x"],
                                                host["lim_y"]]))
        np.testing.assert_array_equal(store["labels"].numpy(),
                                      host["labels"])


def test_conflicting_labels_raise(dataset_dir):
    paths, labels = dataset_dir
    with pytest.raises(ValueError, match="conflicting labels"):
        dd.DeviceDataset(paths[:23] + [paths[0]],
                         labels[:23] + [(labels[0] + 1) % 3],
                         PreprocessSpec(32, 32, 3, "black"), batch_size=8)


def test_mixed_step_equals_host_step_and_jax(dataset_dir):
    paths, labels = dataset_dir
    port, jax_ds = _pair(dataset_dir, batch_size=8, seed=3, shuffle=True,
                         buckets=TWO)
    keys, idxs, weights = next(port.epoch_mixed(shuffle=False))
    jkeys, jidxs, jweights = next(jax_ds.epoch_mixed(shuffle=False))
    assert keys == jkeys
    stores = tuple(port.stores[k] for k in keys)
    # the same images blitted onto one host canvas
    hosts = [{k: v.numpy() for k, v in s.items()} for s in stores]
    n = sum(len(i) for i in idxs)
    canvas = np.zeros((n, 64, 64), np.uint8)
    hw, labs = [], []
    pos = 0
    for host, idx in zip(hosts, idxs):
        for row in idx:
            h, w = host["meta"][3, row], host["meta"][4, row]
            canvas[pos, :h, :w] = host["canvas"][row, :h, :w]
            hw.append((h, w))
            labs.append(host["labels"][row])
            pos += 1
    hb = HostBatch(canvas, np.array([a for a, _ in hw], np.int32),
                   np.array([b for _, b in hw], np.int32),
                   np.array(labs, np.int32), weights, [None] * n)

    jmodel = jax_build("resnet18", num_classes=3, head=(16,))
    variables = jax.device_get(init_variables(jmodel, (32, 32, 3), seed=0))
    lrs = (1e-2, 0.0, 0.0)
    spec = PreprocessSpec(32, 32, 3, border="black")
    out = []
    for batch in (hb, None):
        model = registry.build_model("resnet18", 3, head=(16,))
        model.load_state_dict(checkpoint.from_flax_variables(variables))
        t = Trainer(model, optimizer="SGD", preprocess_spec=spec,
                    device="cpu")
        res = (t.train_batch(batch, 0, lrs) if batch is not None else
               t.train_batch_mixed(stores, idxs, weights, 0, lrs))
        out.append((tuple(float(v) for v in res), t.model.state_dict()))
    (l1, c1, n1), sd1 = out[0]
    (l2, c2, n2), sd2 = out[1]
    assert (l1, c1, n1) == (l2, c2, n2)
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k

    jt = JaxTrainer(jmodel, jax.tree.map(np.copy, variables),
                    optimizer="SGD", preprocess_spec=JaxSpec(32, 32, 3,
                                                             "black"))
    jl, jc, jn = jt.train_batch_mixed(
        tuple(jax_ds.stores[k] for k in jkeys), jidxs, jweights, 0, lrs)
    assert l2 == pytest.approx(float(jl), rel=1e-5)
    assert (c2, n2) == (float(jc), float(jn))
