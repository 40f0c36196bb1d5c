"""The port's dataset image statistics (``sykepic_tpu_torch/train/image.py``)
against the JAX package's (``sykepic_tpu/train/image.py``, which reads with
cv2) on seeded gray, RGB and RGBA PNGs written by cv2. Tolerance: 1e-12
(both compute float64 sums of the same integers, in another order)."""

import numpy as np
import pytest

from sykepic_tpu.train import image as jimage
from sykepic_tpu_torch.train import image

TOL = 1e-12


def _pngs(root, kinds, seed):
    """One cv2-written PNG a kind: "gray" (h, w), "bgr" (h, w, 3), "bgra"
    (h, w, 4), "flat" (a constant gray image, std 0)."""
    import cv2

    rng = np.random.default_rng(seed)
    paths = []
    for i, kind in enumerate(kinds):
        h, w = (int(v) for v in rng.integers(3, 70, 2))
        img = {"gray": lambda: rng.integers(0, 256, (h, w), np.uint8),
               "bgr": lambda: rng.integers(0, 256, (h, w, 3), np.uint8),
               "bgra": lambda: rng.integers(0, 256, (h, w, 4), np.uint8),
               "flat": lambda: np.full((h, w), 77, np.uint8)}[kind]()
        path = root / f"{i:03d}_{kind}.png"
        assert cv2.imwrite(str(path), img)
        paths.append(path)
    return paths


SETS = {
    "gray": ["gray", "gray", "flat"],
    "colour": ["bgr", "bgr", "bgra"],
    "mixed": ["gray", "bgr", "bgra", "flat", "gray", "bgr"],
}


@pytest.mark.parametrize("grayscale", [False, True])
@pytest.mark.parametrize("kinds", sorted(SETS))
def test_mean_std_equals_jax(tmp_path, kinds, grayscale):
    paths = _pngs(tmp_path, SETS[kinds], seed=len(kinds))
    want = jimage.calculate_mean_std(paths, grayscale=grayscale)
    got = image.calculate_mean_std(iter(paths), grayscale=grayscale)
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((1,) if grayscale else (3,))
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_mean_std_channels_come_in_bgr_order(tmp_path):
    import cv2

    bgr = np.zeros((4, 5, 3), np.uint8)
    bgr[..., 0], bgr[..., 1], bgr[..., 2] = 10, 120, 250  # B, G, R
    cv2.imwrite(str(tmp_path / "c.png"), bgr)
    mean, std = image.calculate_mean_std([tmp_path / "c.png"])
    np.testing.assert_allclose(mean, np.array([10, 120, 250]) / 255.0,
                               rtol=0, atol=TOL)
    assert not std.any()


@pytest.mark.parametrize("kinds", sorted(SETS))
def test_mean_dims_equals_jax(tmp_path, kinds):
    paths = _pngs(tmp_path, SETS[kinds], seed=7 + len(kinds))
    assert (image.calculate_mean_dims(iter(paths))
            == jimage.calculate_mean_dims(iter(paths)))


@pytest.mark.parametrize("name,error", [
    ("calculate_mean_std", ZeroDivisionError),
    ("calculate_mean_dims", ValueError)])
def test_empty_list_raises_as_jax(name, error):
    with pytest.raises(error):
        getattr(jimage, name)([])
    with pytest.raises(error):
        getattr(image, name)([])
