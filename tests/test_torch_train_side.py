"""``python -m sykepic_tpu_torch train``'s side modes against the JAX
package's on the small PNG set of ``tests/test_torch_train_loop.py``:

- ``--save-images``: the same file names under ``train/``, ``val/`` and
  ``test/``; without ``--dist`` training goes on, as in JAX;
- ``--dist``: the same bars in the same order (``barh``'s arguments
  captured in both); without matplotlib it raises and writes nothing;
- ``--collage`` with augmentations off: the same images in the same order
  (the two loaders' first shuffled batch is the same), the float batch
  before quantisation within 1e-3 of JAX's resize on the 0-255 scale, and
  the PNG within one uint8 level of JAX's on every pixel;
- ``--collage`` with augmentations on: the grid's shape, uint8 values, and
  the same PNG twice for one seed.
"""

from __future__ import annotations

import configparser

import cv2
import numpy as np
import pytest
import torch

from sykepic_tpu.__main__ import main as jax_main
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.analyze import plot
from sykepic_tpu_torch.train import loop
from test_torch_train_loop import CONFIG, _dataset

TARGET = 32  # [image] shape = 3, 32, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("side") / "dataset")


def _ini(tmp_path, dataset, augmentations="flip, translate, zoom, brightness",
         settings=None):
    text = CONFIG.format(dataset=dataset, models=tmp_path / "models",
                         norm="no").replace(
        "augmentations = flip, translate, zoom, brightness",
        f"augmentations = {augmentations}")
    cfg = configparser.ConfigParser()
    cfg.read_string(text)
    for (section, key), value in (settings or {}).items():
        cfg.set(section, key, value)
    ini = tmp_path / "train.ini"
    with open(ini, "w") as fh:
        cfg.write(fh)
    return ini


def _names(root):
    return {d: sorted(p.name for p in (root / d).iterdir())
            for d in ("train", "val", "test") if (root / d).is_dir()}


@pytest.mark.parametrize("split", ("0.6, 0.2, 0.2", "0.8, 0.2"))
def test_save_images_matches_jax(tmp_path, dataset, split):
    ini = _ini(tmp_path, dataset, settings={("dataset", "split"): split})
    jax_main(["train", str(ini), "--save-images", str(tmp_path / "jax"),
              "--dist", str(tmp_path / "jax.png")])
    assert main(["train", str(ini), "--save-images", str(tmp_path / "port"),
                 "--dist", str(tmp_path / "port.png")]) is None
    names = _names(tmp_path / "port")
    assert names == _names(tmp_path / "jax")
    assert ("test" in names) == (split.count(",") == 2)
    assert sum(map(len, names.values())) == 30


def test_save_images_then_trains(tmp_path, dataset):
    ini = _ini(tmp_path, dataset, settings={("train", "max_epochs"): "1"})
    model_dir = main(["train", str(ini), "--device", "cpu",
                      "--save-images", str(tmp_path / "images")])
    assert (model_dir / "best_state.msgpack").is_file()
    assert len(list((tmp_path / "images").rglob("*.png"))) == 30


def _barh_calls(monkeypatch):
    import matplotlib.pyplot as plt

    calls = []
    real = plt.barh

    def record(labels, totals, **kwargs):
        calls.append((list(labels), list(totals)))
        return real(labels, totals, **kwargs)

    monkeypatch.setattr(plt, "barh", record)
    return calls


@pytest.mark.parametrize("exclude", ("", "striped"))
def test_dist_draws_the_jax_bars(tmp_path, dataset, monkeypatch, exclude):
    ini = _ini(tmp_path, dataset, settings={("dataset", "exclude"): exclude})
    calls = _barh_calls(monkeypatch)
    jax_main(["train", str(ini), "--dist", str(tmp_path / "jax")])
    # no --device: the plot needs no card
    main(["train", str(ini), "--dist", str(tmp_path / "port")])
    (labels, totals), again = calls
    assert again == (labels, totals)
    assert len(labels) == (2 if exclude else 3) and sum(totals) == len(
        labels) * 10
    assert (tmp_path / "port.png").is_file()
    assert not (tmp_path / "models").exists()  # nothing trained


def test_dist_without_matplotlib_raises(tmp_path, dataset, monkeypatch):
    ini = _ini(tmp_path, dataset)
    monkeypatch.setattr(plot, "available", lambda: False)
    with pytest.raises(ImportError, match="matplotlib"):
        main(["train", str(ini), "--dist", str(tmp_path / "d.png")])
    assert not (tmp_path / "d.png").exists()


def _first_batches(ini, rows, cols):
    """The first shuffled collage batch of each package's loader, and the
    port's spec, as ``train --collage`` reads them."""
    from sykepic_tpu.train import config as jax_config
    from sykepic_tpu.train import data as jax_data
    from sykepic_tpu.train import input as jax_input
    from sykepic_tpu_torch.train import config, data, input

    out = []
    for cfg_mod, data_mod, input_mod in ((jax_config, jax_data, jax_input),
                                         (config, data, input)):
        cfg = cfg_mod.read_config(ini)
        model_data = data_mod.ModelData(
            cfg.get("dataset", "path"), (0.6, 0.2, 0.2), None, None, [], 42)
        model_data.oversample(12, None)
        x, y = model_data.train_set()
        batches = iter(input_mod.BatchLoader(x, y, rows * cols, shuffle=True,
                                             num_threads=2))
        out.append(next(batches))
        batches.close()
    return out + [config.get_preprocess_spec(cfg),
                  config.get_augment_spec(cfg)]


@pytest.mark.parametrize("rows,cols", ((2, 2), (3, 4), (4, 3)))
def test_collage_matches_jax(tmp_path, dataset, rows, cols):
    from sykepic_tpu.ops import preprocess as jax_pre

    ini = _ini(tmp_path, dataset, augmentations="")
    jax_batch, batch, spec, augment_spec = _first_batches(ini, rows, cols)
    assert [p.name for p in batch.paths] == [p.name for p in jax_batch.paths]
    for key in ("canvas", "heights", "widths", "labels", "weights"):
        np.testing.assert_array_equal(getattr(batch, key),
                                      getattr(jax_batch, key))
    geometry = jax_pre.compute_geometry(batch.heights, batch.widths, TARGET,
                                        TARGET)
    border = jax_pre.border_values(batch.canvas, batch.heights, batch.widths,
                                   "mode")
    want = np.asarray(jax_pre.resize_pad_batch(
        batch.canvas, batch.heights, batch.widths, *geometry, border,
        TARGET, TARGET))
    got = loop.collage_batch(batch, spec, augment_spec, "cpu")
    assert got.shape == (rows * cols, TARGET, TARGET)
    assert np.abs(got - want).max() <= 1e-3

    jax_main(["train", str(ini), "--collage", str(rows), str(cols),
              str(tmp_path / "jax.png")])
    out = main(["train", str(ini), "--device", "cpu", "--collage", str(rows),
                str(cols), str(tmp_path / "port")])
    assert out == tmp_path / "port.png"
    port_img = cv2.imread(str(out), cv2.IMREAD_UNCHANGED)
    jax_img = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    assert port_img.shape == jax_img.shape == (rows * TARGET, cols * TARGET)
    assert np.abs(port_img.astype(int) - jax_img).max() <= 1
    assert not (tmp_path / "models").exists()  # nothing trained


@pytest.mark.parametrize("augmentations", (
    "flip, translate, zoom, brightness",
    "flip, translate, zoom, rotate, brightness"))
def test_augmented_collage_is_seeded(tmp_path, dataset, augmentations):
    plain = _ini(tmp_path, dataset, augmentations="")
    main(["train", str(plain), "--device", "cpu", "--collage", "3", "3",
          str(tmp_path / "plain.png")])
    ini = _ini(tmp_path, dataset, augmentations=augmentations)
    pngs = []
    for k in range(2):
        main(["train", str(ini), "--device", "cpu", "--collage", "3", "3",
              str(tmp_path / f"aug{k}.png")])
        pngs.append((tmp_path / f"aug{k}.png").read_bytes())
    assert pngs[0] == pngs[1]
    img = cv2.imread(str(tmp_path / "aug0.png"), cv2.IMREAD_UNCHANGED)
    assert img.shape == (3 * TARGET, 3 * TARGET) and img.dtype == np.uint8
    assert not np.array_equal(
        img, cv2.imread(str(tmp_path / "plain.png"), cv2.IMREAD_UNCHANGED))


def test_collage_asks_for_the_card(tmp_path, dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is moot")
    ini = _ini(tmp_path, dataset)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", str(ini), "--collage", "2", "2",
              str(tmp_path / "c.png")])
    assert not (tmp_path / "c.png").exists()
