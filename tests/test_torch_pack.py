"""The port's host shrink (``sykepic_tpu_torch.ingest.pack.shrink_to_fit``,
numpy, no cv2) against the JAX package's (cv2 ``INTER_AREA``), and the slot
packer around it. Tolerance: byte-for-byte equality."""

import numpy as np
import pytest
import torch

from sykepic_tpu.ingest import pack as jpack
from sykepic_tpu_torch.ingest import pack


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _shrunk_both(h, w, rng, max_h=pack.GRID_MAX, max_w=pack.GRID_MAX):
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return (pack.shrink_to_fit(img, max_h, max_w),
            jpack.shrink_to_fit(img, max_h, max_w))


@pytest.mark.parametrize("shape", [
    (2048, 1024),            # an integer factor, 2x2
    (3072, 1536),            # an integer factor, 3x3
    (2048, 40),              # 2x2 with a narrow side
    (1100, 700), (1381, 1034), (1034, 1381),
    (1500, 40),
    (1500, 1),               # the narrow axis stays one pixel
])
def test_shrink_to_fit_equals_jax_cv2_area(shape):
    got, want = _shrunk_both(*shape, np.random.default_rng(sum(shape)))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_shrink_to_fit_equals_jax_on_random_shapes(seed):
    # 8 x 40 seeded shapes between 1025 and 2100 on a side
    rng = np.random.default_rng(100 + seed)
    for h, w in rng.integers(1025, 2101, (40, 2)).tolist():
        got, want = _shrunk_both(h, w, rng)
        assert got.shape == want.shape, (h, w)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w)))


@pytest.mark.parametrize("src,dst", [
    ((90, 60), (30, 20)), ((7, 9), (7, 3)), ((200, 200), (40, 50)),
    ((64, 64), (16, 16)), ((100, 50), (50, 50)), ((5, 5), (5, 5))])
def test_resize_area_equals_cv2(src, dst):
    import cv2

    img = np.random.default_rng(src[0] * src[1]).integers(
        0, 256, src, dtype=np.uint8)
    np.testing.assert_array_equal(
        pack.resize_area_u8(img, *dst),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))


def test_resize_area_only_downscales():
    img = np.zeros((10, 10), np.uint8)
    with pytest.raises(ValueError):
        pack.resize_area_u8(img, 11, 5)


def test_pack_rois_with_an_oversized_roi_matches_jax():
    rng = np.random.default_rng(9)
    rois = [(0, 1, rng.integers(0, 256, (1300, 900), dtype=np.uint8)),
            (0, 2, rng.integers(0, 256, (40, 56), dtype=np.uint8)),
            (1, 3, rng.integers(0, 256, (1300, 900), dtype=np.uint8))]
    kw = dict(batch_size=4, buckets=None, pre_shrink_to=None,
              consolidate_tails=False, compute_modes=True)
    got = list(pack.pack_rois(rois, **kw))
    want = list(jpack.pack_rois(rois, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.canvas.shape == w.canvas.shape
        np.testing.assert_array_equal(g.canvas, w.canvas)
        for name in ("heights", "widths", "roi_ids", "sample_idx", "modes"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert g.n_valid == w.n_valid
    big = next(g for g in got if g.canvas.shape[1:] == (1024, 960))
    assert big.widths[:2].tolist() == [708, 708]
