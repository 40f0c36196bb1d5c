"""A PNG reader and writer with ``zlib``, numpy and the port's native host
library.

The JAX package decodes training images with ``cv2.imread(path,
IMREAD_GRAYSCALE)`` (``sykepic_tpu/train/input.py:56-69``); the port
does not depend on ``cv2``, so it reads PNGs itself:

- 8-bit grayscale, 8-bit RGB and 8-bit RGBA, non-interlaced, with all five
  row filters (None, Sub, Up, Average, Paeth). The port's native host
  library (``ingest/native``) undoes the filters; without it, Sub and Up are
  vectorised and Average and Paeth rows run a per-byte Python loop, since
  each byte needs its reconstructed left neighbour. libpng picks filters
  adaptively, so PNGs written by cv2 carry all five.
- Colour goes to gray as ``cv2.imread(..., IMREAD_GRAYSCALE)`` does it: libpng's
  ``png_set_rgb_to_gray(0.299, 0.587)`` with its integer weights 9797, 19234
  and 3737 (over 2**15) and truncation; alpha is dropped. IFCB PNGs are gray
  copied into three channels, which every weighting returns unchanged.
- Anything else (16-bit, palette, gray with alpha, interlaced) raises
  ``ValueError`` naming the file.

:func:`write_png` writes 8-bit grayscale, filter 0 by default or the row
filters it is given (tests and the smoke run build their datasets with
it); :func:`png_dims` reads the size from the IHDR chunk without decoding
(``sykepic_tpu/train/input.py:40-53``).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel (8-bit)
# libpng's png_set_rgb_to_gray(0.299, 0.587) in 1/32768 units
_GRAY_WEIGHTS = (9797, 19234, 3737)


def png_dims(path):
    """(h, w) from a PNG's IHDR header without decoding pixels, or None
    for unreadable/non-PNG files."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
    except OSError:
        return None
    if head[:8] == SIGNATURE and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return int(h), int(w)
    return None


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG without an IEND chunk")


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path) -> np.ndarray:
    from ..ingest import native  # here: ingest.ifcb imports this module

    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    if h and int(rows[:, 0].max()) > 4:
        raise ValueError(f"{path}: unknown PNG row filter "
                         f"{int(rows[:, 0].max())}")
    out = native.png_unfilter(rows, bpp)
    if out is not None:
        return out
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum along the row, per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        else:  # Average (3) or Paeth (4)
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(),
                                                        bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """PNG bytes -> 2-D uint8 grayscale (see the module docstring)."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = ihdr
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{colour}, interlace {interlace}); only non-interlaced 8-bit "
            "gray, RGB and RGBA are read")
    bpp = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from e
    img = _unfilter(raw, h, w * bpp, bpp, path).reshape(h, w, bpp)
    if bpp == 1:
        return img[:, :, 0]
    rgb = img[:, :, :3].astype(np.uint32)
    wr, wg, wb = _GRAY_WEIGHTS
    return ((rgb[..., 0] * wr + rgb[..., 1] * wg + rgb[..., 2] * wb)
            >> 15).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode one PNG file to 2-D uint8 grayscale."""
    return decode_png(Path(path).read_bytes(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(img: np.ndarray, filters) -> np.ndarray:
    """Row ``y`` of a 2-D uint8 image filtered with ``filters[y %
    len(filters)]`` (0-4), its filter byte first: ``(h, 1 + w)`` uint8."""
    h, w = img.shape
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    kinds = np.asarray(filters, np.int64)[np.arange(h) % len(filters)]
    body = ((x - preds[kinds, np.arange(h)]) & 0xFF).astype(np.uint8)
    return np.concatenate([kinds[:, None].astype(np.uint8), body], axis=1)


def encode_png(img: np.ndarray, level: int = 6, filters=(0,)) -> bytes:
    """2-D uint8 array -> PNG bytes (8-bit gray; row ``y`` takes the row
    filter ``filters[y % len(filters)]``, 0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"write_png takes a 2-D gray image, got {img.shape}")
    if not filters or not set(filters) <= {0, 1, 2, 3, 4}:
        raise ValueError(f"PNG row filters are 0-4, got {filters}")
    h, w = img.shape
    rows = _filter_rows(img, filters)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, level: int = 6, filters=(0,)) -> None:
    Path(path).write_bytes(encode_png(img, level, filters))
