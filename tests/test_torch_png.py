"""The port's PNG reader (``sykepic_tpu_torch/utils/png.py``) against
``cv2.imread(path, IMREAD_GRAYSCALE)``, which the JAX package's training
input uses (``sykepic_tpu/train/input.py:56-69``): equal arrays on gray, RGB
and RGBA PNGs written by cv2 at several compression levels (libpng mixes
all five row filters at explicit levels; cv2's default writes Sub only),
odd widths included, through the native unfilter and through its Python
twin; the port's writer with each row filter read back by cv2;
``png_dims`` equal to the JAX function; unsupported PNGs raise naming the
file."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from sykepic_tpu.train import input as jax_input
from sykepic_tpu_torch.ingest import native
from sykepic_tpu_torch.utils import png


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    """The native unfilter, or its Python twin (native made unavailable)."""
    if request.param == "native":
        assert native.lib() is not None, "the native host library did not build"
    else:
        monkeypatch.setattr(native, "png_unfilter", lambda rows, bpp: None)
    return request.param


def _image(rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    # smooth ramps next to noise, so the adaptive filter choice varies by row
    ramp = (np.arange(shape[1]) * 255 // max(shape[1] - 1, 1)).astype(np.uint8)
    img[: shape[0] // 2, : shape[1] // 2] = (
        ramp[: shape[1] // 2, None] if img.ndim == 3
        else ramp[: shape[1] // 2])
    return img


@pytest.mark.parametrize("level", [None, 0, 1, 4, 9])
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_decoder_equals_cv2(tmp_path, level, kind, backend):
    rng = np.random.default_rng(hash((level, kind)) % 2**32)
    chans = {"gray": (), "rgb": (3,), "rgba": (4,)}[kind]
    params = [] if level is None else [cv2.IMWRITE_PNG_COMPRESSION, level]
    for h, w in ((37, 61), (1, 1), (5, 3), (64, 181), (180, 97)):
        img = _image(rng, (h, w, *chans))
        if kind == "gray" and h > 4:
            img[h // 3] = img[h // 3 - 1]  # an Up-friendly row
        path = tmp_path / f"{kind}_{h}x{w}.png"
        assert cv2.imwrite(str(path), img, params)
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        got = png.read_png(path)
        assert got.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_mixed_filters_are_exercised(tmp_path, backend):
    # the explicit-level files above carry every filter type
    img = _image(np.random.default_rng(0), (64, 181))
    path = tmp_path / "f.png"
    cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    data = path.read_bytes()
    idat = b"".join(body for kind, body in png._chunks(data, path)
                    if kind == b"IDAT")
    raw = zlib.decompress(idat)
    filters = {raw[y * 182] for y in range(64)}
    assert filters >= {1, 2, 4}, filters
    np.testing.assert_array_equal(png.read_png(path),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_writer_round_trips_through_cv2(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (23, 45), dtype=np.uint8)
    path = tmp_path / "w.png"
    png.write_png(path, img)
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (1, 2, 3, 4), (4, 3, 0, 2, 1)])
def test_filtered_writer_round_trips_through_cv2(tmp_path, filters, backend):
    rng = np.random.default_rng(len(filters) * 7 + filters[0])
    for h, w in ((1, 1), (9, 2), (31, 47), (64, 181)):
        img = _image(rng, (h, w))
        path = tmp_path / f"w_{h}x{w}.png"
        png.write_png(path, img, level=1, filters=filters)
        data = path.read_bytes()
        idat = b"".join(body for kind, body in png._chunks(data, path)
                        if kind == b"IDAT")
        raw = zlib.decompress(idat)
        assert [raw[y * (w + 1)] for y in range(h)] == [
            filters[y % len(filters)] for y in range(h)]
        np.testing.assert_array_equal(
            cv2.imread(str(path), cv2.IMREAD_UNCHANGED).reshape(h, w), img)
        np.testing.assert_array_equal(png.read_png(path), img)


def test_writer_rejects_unknown_filters():
    with pytest.raises(ValueError, match="0-4"):
        png.encode_png(np.zeros((2, 2), np.uint8), filters=(5,))


def test_png_dims_equal_the_jax_function(tmp_path):
    img = np.zeros((17, 29), np.uint8)
    good = tmp_path / "a.png"
    cv2.imwrite(str(good), img)
    junk = tmp_path / "b.png"
    junk.write_bytes(b"not a png at all, longer than 24 bytes")
    for p in (good, junk, tmp_path / "missing.png"):
        assert png.png_dims(p) == jax_input.png_dims(p)
    assert png.png_dims(good) == (17, 29)


def _png_with(ihdr: bytes, rows: bytes) -> bytes:
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(rows))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("what", ["16bit", "palette", "gray_alpha",
                                  "interlaced", "not_png", "bad_filter"])
def test_unsupported_pngs_raise_naming_the_file(tmp_path, what, backend):
    path = tmp_path / f"{what}.png"
    if what == "16bit":
        cv2.imwrite(str(path), np.full((4, 5), 1000, np.uint16))
    elif what == "not_png":
        path.write_bytes(b"GIF89a" + bytes(40))
    else:
        depth, colour, interlace, row = {
            "palette": (8, 3, 0, b"\0" + bytes(5)),
            "gray_alpha": (8, 4, 0, b"\0" + bytes(10)),
            "interlaced": (8, 0, 1, b"\0" + bytes(5)),
            "bad_filter": (8, 0, 0, b"\x07" + bytes(5)),
        }[what]
        ihdr = struct.pack(">IIBBBBB", 5, 1, depth, colour, 0, 0, interlace)
        path.write_bytes(_png_with(ihdr, row))
    with pytest.raises(ValueError, match=what):
        png.read_png(path)
