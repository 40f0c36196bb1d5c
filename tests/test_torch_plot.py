"""The port's plotting helpers (``sykepic_tpu_torch/analyze/plot.py``)
against the JAX package's on the same inputs: ``view_batch``'s collage is
the same uint8 array and its PNG (the port's own writer, where JAX calls
``cv2.imwrite``) decodes to the same pixels; ``dataset_distribution`` draws
the same bars in the same order (``barh``'s arguments captured in both);
``class_plot``, ``plot_img`` and ``plot_stats`` write the same PNG bytes
(both draw with the same matplotlib)."""

from __future__ import annotations

from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from sykepic_tpu.analyze import plot as jax_plot
from sykepic_tpu_torch.analyze import plot
from sykepic_tpu_torch.utils import png


@pytest.mark.parametrize("channels", (None, 1, 3))
@pytest.mark.parametrize("rows,cols", ((2, 3), (None, 4), (3, None),
                                       (None, None)))
def test_view_batch_matches_jax(tmp_path, rows, cols, channels):
    rng = np.random.default_rng(7)
    shape = (12, 9, 7) if channels is None else (12, 9, 7, channels)
    images = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    want = jax_plot.view_batch(images, h=rows, w=cols)
    got = plot.view_batch(images, h=rows, w=cols)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8
    jax_png, port_png = tmp_path / "jax.png", tmp_path / "port.png"
    assert jax_plot.view_batch(images, rows, cols, save=jax_png) == jax_png
    assert plot.view_batch(images, rows, cols, save=port_png) == port_png
    np.testing.assert_array_equal(
        cv2.imread(str(port_png), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(jax_png), cv2.IMREAD_UNCHANGED))


def test_view_batch_rejects_other_channel_counts(tmp_path):
    with pytest.raises(ValueError, match="1 or 3"):
        plot.view_batch(np.zeros((4, 5, 5, 2)), save=tmp_path / "x.png")


@pytest.mark.parametrize("filters", ((0,), (1, 2, 3, 4)))
def test_rgb_png_round_trips(tmp_path, filters):
    """Colour type 2 (``view_batch`` of a colour batch): cv2 and the port's
    reader decode what ``write_png`` wrote, whatever the row filters."""
    img = np.random.default_rng(3).integers(0, 256, (13, 17, 3), np.uint8)
    path = tmp_path / "rgb.png"
    png.write_png(path, img, filters=filters)
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1], img)
    np.testing.assert_array_equal(png.decode_png_channels(path.read_bytes()),
                                  img)


def _capture(monkeypatch):
    import matplotlib.pyplot as plt

    calls = []
    for name in ("barh", "text"):
        real = getattr(plt, name)

        def record(*args, _name=name, _real=real, **kwargs):
            calls.append((_name, [list(a) if isinstance(a, (list, tuple))
                                  else a for a in args],
                          {k: v for k, v in kwargs.items()}))
            return _real(*args, **kwargs)

        monkeypatch.setattr(plt, name, record)
    return calls


@pytest.mark.parametrize("seed", range(3))
def test_dataset_distribution_draws_the_jax_bars(tmp_path, monkeypatch,
                                                 seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 40, 9)
    counts[:3] = counts[3]  # equal totals: alphabetical among equals
    data = SimpleNamespace(distribution={
        f"class_{chr(ord('a') + int(k))}": [int(n), 0, 0, 0]
        for k, n in zip(rng.permutation(9), counts)})
    calls = _capture(monkeypatch)
    jax_plot.dataset_distribution(data, save=tmp_path / "jax.png")
    want = list(calls)
    calls.clear()
    plot.dataset_distribution(data, save=tmp_path / "port.png")
    assert calls == want
    (_, (labels, totals), _) = calls[0]
    assert totals == sorted(totals) and len(labels) == 9
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())


def test_class_plot_matches_jax(tmp_path):
    from sykepic_tpu_torch.__main__ import main

    csv = tmp_path / "class.csv"
    main(["class", "tests/data/prob", "--feat", "tests/data/feat",
          "-t", "tests/model/thresholds-zero.txt", "-o", str(csv)])
    for columns in ([1, 2], ["Uroglenopsis sp", "Total"]):
        want = jax_plot.class_plot(csv, columns, out_file=tmp_path / "j.png")
        got = plot.class_plot(csv, columns, out_file=tmp_path / "p.png")
        assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("shape", ((20, 30), (20, 30, 1), (20, 30, 3)))
def test_plot_img_matches_jax(tmp_path, shape):
    img = np.random.default_rng(5).integers(0, 256, shape, np.uint8)
    jax_plot.plot_img(img, "jax", save=tmp_path / "j.png")
    plot.plot_img(img, "jax", save=tmp_path / "p.png")
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_plot_stats_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    series = [list(rng.uniform(0, 1, 14)) for _ in range(4)]
    jax_plot.plot_stats(*series, title="t", outfile=tmp_path / "j.png",
                        first_epoch=1, epoch_step=3)
    plot.plot_stats(*series, title="t", outfile=tmp_path / "p.png",
                    first_epoch=1, epoch_step=3)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
