"""The port's host features (``sykepic_tpu_torch/compute/features.py``, a
copy of ``sykepic_tpu/compute/features.py``) against the JAX package's, on
the CPU: ``compute_features`` and ``segment_roi`` give exactly the same
mask, the same feature list and the same Python types (the ``.feat.csv``
is written with ``str()``), on the fixture's ROIs, 30 seeded ROIs in
``bench.py``'s size mix, a blank ROI and a 1-pixel ROI. The golden-fixture
values and bounds of ``tests/test_feature.py`` hold for the port, and 8 or
16 threads over the same ROIs (the host-thread ``pipeline``'s pool, sharing
the filter-bank cache) give the same values as one.

Helpers :func:`seeded_rois` and :func:`write_seeded_sample` serve the other
slice-6a test files.
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pytest
import torch
from pytest import approx

import bench
from sykepic_tpu.compute import features as jax_features
from sykepic_tpu.ingest import ifcb as jax_ifcb
from sykepic_tpu_torch.compute import feature_native, features
from sykepic_tpu_torch.ingest import ifcb

FIXTURE = "tests/data/raw/valid/D20180712T065600_IFCB114"
N_SEEDED = 30


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def seeded_rois(n, seed):
    """``n`` uint8 ROIs in ``bench.py``'s size mix: fixture ROIs resampled
    (nearest) to each shape, with seeded noise of +-3 levels."""
    images = [img for _, img in jax_ifcb.read_sample(FIXTURE).images()]
    rng = np.random.default_rng(seed)
    out = []
    for h, w in bench._roi_shapes(rng, n):
        src = images[int(rng.integers(len(images)))]
        ys = np.arange(h) * src.shape[0] // h
        xs = np.arange(w) * src.shape[1] // w
        noise = rng.integers(-3, 4, (h, w))
        out.append(np.clip(src[np.ix_(ys, xs)].astype(np.int16) + noise, 0,
                           255).astype(np.uint8))
    return out


def write_seeded_sample(raw_dir, name, n, seed):
    """A genuine ``.adc/.roi/.hdr`` triplet of :func:`seeded_rois`."""
    return bench._write_sample_triplet(raw_dir, name, seeded_rois(n, seed))


def _cases():
    rois = [img for _, img in ifcb.read_sample(FIXTURE).images()]
    rois += seeded_rois(N_SEEDED, seed=11)
    rois.append(np.full((40, 60), 200, np.uint8))  # blank
    rois.append(np.full((1, 1), 17, np.uint8))  # one pixel
    return rois


CASES = _cases()


def test_cases_cover_the_size_mix():
    shapes = [r.shape for r in CASES]
    assert len(CASES) == 2 + N_SEEDED + 2
    assert max(h for h, _ in shapes) > 64 and max(w for _, w in shapes) > 128
    assert (1, 1) in shapes


@pytest.mark.parametrize("i", range(len(CASES)))
def test_compute_features_equal_jax(i):
    roi = CASES[i]
    mask, got = features.compute_features(roi)
    want_mask, want = jax_features.compute_features(roi)
    assert mask.dtype == want_mask.dtype
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(features.segment_roi(roi), want_mask)
    assert got == want
    assert [type(v) for _, v in got] == [type(v) for _, v in want]
    assert [str(v) for _, v in got] == [str(v) for _, v in want]


def test_blank_and_single_pixel_rois():
    for roi in CASES[-2:]:
        mask, feats = features.compute_features(roi)
        assert not mask.any()
        assert dict(feats)["Area"] == 0 and dict(feats)["NumBlobs"] == 0


def test_constants_equal_jax():
    for name in ("HYST_HIGH", "HYST_LOW", "DARK_OTSU_SCALE", "MIN_BLOB_AREA",
                 "_BANK_CACHE_BYTES"):
        assert getattr(features, name) == getattr(jax_features, name), name
    np.testing.assert_array_equal(features.DISK2, jax_features.DISK2)


def test_feature_goldens_deterministic():
    """``tests/test_feature.py``'s deterministic values of the algorithm
    on the fixture ROIs (px units)."""
    vol, feats = feature_native.sample_features(FIXTURE)
    rows = {r[0]: r for r in feats}
    assert rows[2][4] == 218
    assert rows[2][1] == approx(1441.7241196448167, rel=1e-9)
    assert rows[2][5] == approx(22.711136414416153, rel=1e-9)
    assert rows[2][6] == approx(13.516578710081625, rel=1e-9)
    assert rows[3][4] == 1816
    assert rows[3][1] == approx(73850.69897573987, rel=1e-9)
    assert rows[3][5] == approx(64.3156081825781, rel=1e-9)
    assert rows[3][6] == approx(38.27352858050683, rel=1e-9)


def test_consistency_with_reference_fixture():
    """``tests/test_feature.py``'s bounds against the reference's golden
    CSV: area within 2%, axes within 5%, biovolume within 0.5%."""
    ref = pd.read_csv("tests/data/feat/D20180712T065600_IFCB114.feat.csv",
                      comment="#", index_col=0)
    vol, feats = feature_native.sample_features(FIXTURE)
    assert vol == approx(0.9854949375, rel=1e-9)
    ours = {r[0]: r for r in feats}
    for roi in (2, 3):
        ref_row = ref.loc[roi]
        assert ours[roi][4] == approx(ref_row["area"], rel=0.02)
        assert ours[roi][5] == approx(ref_row["major_axis_length"], rel=0.05)
        assert ours[roi][6] == approx(ref_row["minor_axis_length"], rel=0.05)
        assert ours[roi][1] == approx(ref_row["biovolume_px"], rel=0.005)


@pytest.mark.parametrize("threads", [8, 16])
def test_threads_equal_one(threads):
    """The host-thread pipeline's pool (8 threads by default, and more
    than the host's cores) shares the filter-bank cache, emptied first so
    that the threads race to build it, under a short switch interval; the
    values are the serial ones and the cache's byte count is the sum of
    its entries (a lost update would break it)."""
    with features._bank_lock:
        features._bank_cache.clear()
        features._bank_cache_total = 0
    rois = CASES * 2  # repeated shapes: cache hits beside builds
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            threaded = list(pool.map(features.compute_features, rois,
                                     timeout=300))
    finally:
        sys.setswitchinterval(interval)
    for roi, (mask, feats) in zip(rois, threaded):
        want_mask, want = jax_features.compute_features(roi)
        np.testing.assert_array_equal(mask, want_mask)
        assert feats == want
    assert features._bank_cache_total == sum(
        b for _, b in features._bank_cache.values())
