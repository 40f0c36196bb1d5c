"""The port's eval preprocessing (``sykepic_tpu_torch.ops.preprocess``, the
module that holds the resize/pad kernel K1) against the JAX package.

The plain twin and ``eval_preprocess(device="cpu")`` are held against the
einsum ``resize_pad_batch_mxu`` and the Pallas kernel in interpret mode.
Tolerance ``atol=1e-3`` on the 0-255 scale (``1e-3/255`` after the
division): the existing Pallas-vs-einsum bound, because the einsum sums
``max(0, 1-|f-t|)``-weighted taps over the whole axis while the twin
blends two taps, so the float sums associate differently. Geometry and
border values are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sykepic_tpu.ingest import ifcb as jifcb
from sykepic_tpu.ingest import pack as jpack
from sykepic_tpu.ops import pallas_preprocess
from sykepic_tpu.ops import preprocess as jpre
from sykepic_tpu_torch.ingest import pack, shelf
from sykepic_tpu_torch.ops import preprocess, resize_pad

FIXTURE = "tests/data/raw/valid/D20180712T065600_IFCB114"
ATOL = 1e-3  # on the 0-255 scale


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_batch(b=5, ch=48, cw=64, seed=0):
    rng = np.random.default_rng(seed)
    canvas = np.zeros((b, ch, cw), np.uint8)
    heights = np.zeros(b, np.int32)
    widths = np.zeros(b, np.int32)
    for i in range(b):
        h, w = int(rng.integers(5, ch)), int(rng.integers(5, cw))
        canvas[i, :h, :w] = rng.integers(0, 255, (h, w), np.uint8)
        heights[i], widths[i] = h, w
    border = rng.integers(0, 255, b).astype(np.uint8)
    return canvas, heights, widths, border


def _jax_refs(canvas, heights, widths, border, target):
    geom = jpre.compute_geometry(heights, widths, target, target)
    args = tuple(jnp.asarray(a) for a in (canvas, heights, widths, *geom,
                                          border))
    mxu = np.asarray(jpre.resize_pad_batch_mxu(*args, target, target))
    pallas = np.asarray(pallas_preprocess.resize_pad_batch_pallas(
        *args, target, target, interpret=True))
    return geom, mxu, pallas


@pytest.mark.parametrize("seed,target", [(0, 96), (1, 40), (2, 180)])
def test_twin_matches_einsum_and_pallas(seed, target):
    canvas, heights, widths, border = make_batch(seed=seed)
    geom, mxu, pallas = _jax_refs(canvas, heights, widths, border, target)
    out = preprocess.resize_pad_batch(
        torch.from_numpy(canvas), heights, widths, *geom, border,
        target, target).numpy()
    np.testing.assert_allclose(out, mxu, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=0)


def _fixture_batch():
    rois = jifcb.read_sample(FIXTURE)
    tagged = [(0, rid, img) for rid, img in rois.images()]
    (batch,) = jpack.pack_rois(tagged, batch_size=2, buckets=((64, 128),))
    border = jpre.border_values(batch.canvas, batch.heights, batch.widths,
                                "mode")
    return batch, border


def test_fixture_rois_match_einsum_and_pallas():
    batch, border = _fixture_batch()
    geom, mxu, pallas = _jax_refs(batch.canvas, batch.heights, batch.widths,
                                  border, 180)
    out = preprocess.resize_pad_batch(
        torch.from_numpy(batch.canvas), batch.heights, batch.widths, *geom,
        border, 180, 180).numpy()
    np.testing.assert_allclose(out, mxu, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=0)


def test_eval_preprocess_cpu_matches_jax():
    """The whole eval contract: NHWC, /255, replicated to 3 channels."""
    batch, border = _fixture_batch()
    geom = jpre.compute_geometry(batch.heights, batch.widths, 180, 180)
    args = (batch.canvas, batch.heights, batch.widths, *geom, border)
    want = np.asarray(jpre.eval_preprocess(
        *(jnp.asarray(a) for a in args), target_h=180, target_w=180,
        num_chans=3))
    before = resize_pad.launches
    got = preprocess.eval_preprocess(
        torch.from_numpy(batch.canvas), *args[1:], target_h=180,
        target_w=180, num_chans=3)
    assert resize_pad.launches == before  # CPU tensors take the twin
    assert got.shape == want.shape == (2, 180, 180, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL / 255, rtol=0)


def _shelf_rois(n=60, seed=3):
    """Crops of the fixture ROIs, some wider than a window's share."""
    imgs = [img for _, img in jifcb.read_sample(FIXTURE).images()]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        src = imgs[i % len(imgs)]
        h = int(rng.integers(1, src.shape[0] + 1))
        w = int(rng.integers(1, src.shape[1] + 1))
        y = int(rng.integers(0, src.shape[0] - h + 1))
        x = int(rng.integers(0, src.shape[1] - w + 1))
        out.append((0, i + 1, np.ascontiguousarray(src[y:y + h, x:x + w])))
    return out


def test_shelf_origins_match_slot_path_and_jax():
    rois = _shelf_rois()
    (sb,) = list(shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                                    compute_modes=True))
    n = sb.n_valid
    geom = preprocess.compute_geometry(sb.heights[:n], sb.widths[:n],
                                       180, 180)
    border = sb.modes[:n]
    shelf_out = preprocess.resize_pad_batch(
        torch.from_numpy(sb.windows), sb.heights[:n], sb.widths[:n], *geom,
        border, 180, 180, y_origin=sb.y0[:n], x_origin=sb.x0[:n],
        win_idx=sb.win_idx[:n]).numpy()

    # the same ROIs, each alone in its own canvas (origin 0)
    by_id = {rid: img for _, rid, img in rois}
    canvas = np.zeros((n, 192, 512), np.uint8)
    for r in range(n):
        img = by_id[int(sb.roi_ids[r])]
        canvas[r, :img.shape[0], :img.shape[1]] = img
    slot_out = preprocess.resize_pad_batch(
        torch.from_numpy(canvas), sb.heights[:n], sb.widths[:n], *geom,
        border, 180, 180).numpy()
    np.testing.assert_array_equal(shelf_out, slot_out)

    # the JAX shelf path: per-slot window copy + einsum with origins
    slabs = sb.windows[sb.win_idx[:n]]
    want = np.asarray(jpre.resize_pad_batch_mxu(
        *(jnp.asarray(a) for a in (slabs, sb.heights[:n], sb.widths[:n],
                                   *geom, border)),
        180, 180, y_origin=jnp.asarray(sb.y0[:n]),
        x_origin=jnp.asarray(sb.x0[:n])))
    np.testing.assert_allclose(shelf_out, want, atol=ATOL, rtol=0)


def test_compute_geometry_exact():
    rng = np.random.default_rng(5)
    h = np.concatenate([[56, 70, 180, 1, 600], rng.integers(1, 600, 500)])
    w = np.concatenate([[70, 56, 180, 600, 1], rng.integers(1, 600, 500)])
    for target in ((180, 180), (224, 224), (96, 128)):
        got = preprocess.compute_geometry(h, w, *target)
        want = jpre.compute_geometry(h, w, *target)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
            assert g.dtype == np.int32
    # float64 truncation: 11 * (180 / 33.0) = 59.99999999999999 -> 59, and
    # 56 * (180 / 70.0) is exactly 144.0
    new_h = preprocess.compute_geometry([11, 56], [33, 70], 180, 180)[0]
    np.testing.assert_array_equal(new_h, [59, 144])


@pytest.mark.parametrize("mode", ["mode", "white", "black"])
def test_border_values_match_jax(mode):
    canvas, heights, widths, _ = make_batch(b=8, seed=4)
    np.testing.assert_array_equal(
        preprocess.border_values(canvas, heights, widths, mode),
        jpre.border_values(canvas, heights, widths, mode))


def test_slot_meta_rows_and_plain_version():
    """The (10, R) metadata and the kernel's plain version: NHWC in the
    requested dtype, equal to the twin divided by 255 and replicated."""
    canvas, heights, widths, border = make_batch(seed=6)
    geom = preprocess.compute_geometry(heights, widths, 64, 64)
    meta = preprocess.slot_meta(heights, widths, *geom, border)
    assert meta.shape == (len(preprocess.META_ROWS), 5)
    assert meta.dtype == np.int32
    np.testing.assert_array_equal(meta[0], np.arange(5))
    np.testing.assert_array_equal(meta[1:3], 0)
    twin = preprocess.resize_pad_batch(torch.from_numpy(canvas), heights,
                                       widths, *geom, border, 64, 64)
    for dtype in (torch.float32, torch.bfloat16):
        out = resize_pad.resize_pad(torch.from_numpy(canvas),
                                    torch.from_numpy(meta), 64, 64, 3, dtype)
        assert out.shape == (5, 64, 64, 3) and out.dtype == dtype
        assert out.is_contiguous()
        want = (twin / 255.0)[..., None].expand(-1, -1, -1, 3).to(dtype)
        torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_pre_shrink_feeds_the_same_geometry_as_jax():
    """ROIs over the target are pre-shrunk on the host by the port's own
    INTER_LINEAR downscale; the dims it picks are the JAX package's."""
    rng = np.random.default_rng(8)
    for h, w in ((181, 40), (600, 599), (250, 700), (179, 900)):
        img = rng.integers(0, 256, (h, w), np.uint8)
        got = pack.pre_shrink(img, 180, 180)
        assert got.shape == jpack.pre_shrink(img, 180, 180).shape
