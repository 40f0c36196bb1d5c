"""Lossless wire codec for shelf windows: fewer host->device bytes.

A copy of the JAX package's codec (same format, same encoder, same
``decode_reference``), kept in the port so that the port needs nothing of
that package. The codec was designed for a TPU behind a slow link, where the
classification stream was bound by upload bytes; whether it still pays over
PCIe on the card is an open question that ``PERF.md`` tracks
(``SYKEPIC_WIRE_CODEC=off`` ships raw windows).

Scheme:

- Per window, pixels are predicted by their top neighbour (vertical,
  flag 0), left neighbour (horizontal, flag 1), or the planar gradient
  ``left + up - upleft`` (flag 2: its deltas are second differences, so
  decode is cumsum along rows THEN columns); the encoder picks the cheapest
  per window (1 flag byte). Out-of-range neighbours predict 0, i.e.
  row/col 0 stores absolute values — no special case.
- Prediction deltas are stored mod 16 in a dense 4-bit plane (half the
  raw bytes). Deltas outside [-8, 7] leave a nonzero mod-256 residual;
  those are *exceptions*.
- Exceptions ship as ONE u8 stream over the whole dispatch in scan
  order, one byte per entry: high nibble = position advance, low
  nibble = residual >> 4 (mod-256 residuals are always multiples of 16
  because the nibble plane already carries delta mod 16). A zero low
  nibble marks a *dummy* whose advance counts 15x (up to 225 px), so
  sparse exception streams stay cheap; a full zero byte is padding
  (advance 0, add 0 — a no-op). The stream pads to a multiple of
  ``CHUNK`` entries.
- Decode = unpack nibbles -> scatter-add residuals -> cumsum mod 256
  along the predictor axis (axes, chained, for the gradient)
  (:mod:`sykepic_tpu_torch.ops.wiredecode`). Exact: all arithmetic is mod
  256, so ``decode(encode(w)) == w`` bit-for-bit for ANY uint8 content.

When the content does not compress (noise-like windows, tiny tail
dispatches), :func:`encode` returns ``None`` and the caller ships the raw
windows — the codec can therefore never cost wire bytes, only save them.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from dataclasses import dataclass

import numpy as np

# Exception-stream chunking is part of the format (the JAX decoder chains
# one fixed-shape scatter per chunk); the port's decoder scatters the whole
# stream at once, and padding entries are no-ops. The chunk scales with the
# tensor (power of two, ~npx/32, clamped below) so small dispatches — the
# slot path, stream tails — don't drown in padding: the worst-case
# padding is one chunk, ~3% of the tensor's raw bytes.
CHUNK = 65536  # ceiling: full shelf dispatches (6.3 MB) use this
MIN_CHUNK = 4096


def chunk_for(npx: int) -> int:
    """Exception-chunk length for an ``npx``-pixel dispatch (consistent
    between encoder padding and decoder slicing via ``WirePayload.chunk``)."""
    c = MIN_CHUNK
    while c < CHUNK and c * 32 < npx:
        c *= 2
    return c

# Ship encoded only when it saves at least this fraction of the raw bytes
# (the decode work is nearly free next to the CNN, but switching
# representations for a ~1% win would churn program cache entries).
MIN_SAVING = 0.03

# The C++ encoder (ingest/native/ifcb_native.cpp::wire_encode) is the hot
# path (~10x the NumPy twin below; the producer thread must outrun the
# link); tests flip this off to pin the NumPy contract and byte-equality.
USE_NATIVE = True


@dataclass
class WirePayload:
    """Encoded stand-in for a ``ShelfBatch.windows`` tensor."""

    plane: np.ndarray  # (Nc, H, W//2) uint8 -- packed 4-bit deltas
    exc: np.ndarray  # (E,) uint8 -- advance<<4 | residual>>4 (E % chunk == 0)
    flags: np.ndarray  # (Nc,) uint8 -- 0 = vertical, 1 = horizontal
    shape: tuple[int, int, int]  # original windows shape
    n_exc: int  # real exception entries (before dummies/chunk padding)
    chunk: int = CHUNK  # scatter-chunk length this payload was padded to

    @property
    def nbytes(self) -> int:
        return self.plane.nbytes + self.exc.nbytes + self.flags.nbytes


# Payload-buffer pool, keyed by (shape or size): like the shelf window
# pool (ingest/shelf.py), recycling multi-MB buffers spares each dispatch
# fresh mmap page faults. The engine recycles a payload
# once its dispatch has drained (upload provably complete). deque ops
# are GIL-atomic; the capacity tracks the engine's in-flight pipeline
# depth (same env default as engine.PIPELINE_DEPTH) plus slack.
from .shelf import POOL_CAP

_POOL: dict[object, deque] = defaultdict(lambda: deque(maxlen=POOL_CAP))
_SCRATCH = threading.local()  # native encoder's exception scratch


def _pooled(key, alloc):
    try:
        return _POOL[key].pop()
    except IndexError:
        return alloc()


def recycle_payload(payload: "WirePayload | None") -> None:
    """Return a drained payload's plane/exc buffers to the pool. Callers
    must guarantee the device copy completed (the engine's drain stage)."""
    if payload is None:
        return
    if payload.plane.dtype == np.uint8:
        _POOL[("plane",) + payload.plane.shape].append(payload.plane)
    if payload.exc.dtype == np.uint8 and payload.exc.size:
        _POOL[("exc", payload.exc.size)].append(payload.exc)


def _exc_scratch(cap: int) -> np.ndarray:
    buf = getattr(_SCRATCH, "buf", None)
    if buf is None or buf.size < cap:
        _SCRATCH.buf = buf = np.empty(cap, np.uint8)
    return buf[:cap]


def _signed4(d: np.ndarray) -> np.ndarray:
    """The value the decoder reconstructs from ``d & 15`` (two's
    complement nibble in [-8, 7])."""
    return ((d + 8) & 15) - 8


def encode(windows: np.ndarray, force: bool = False) -> WirePayload | None:
    """Encode one dispatch's windows; ``None`` when raw ships cheaper.

    ``windows`` must be a C-contiguous uint8 array of shape (Nc, H, W)
    with W even (shelf windows are (192, 512)). ``force`` skips the
    payoff gate (tests exercising exactness on tiny dispatches).
    """
    nc, h, w = windows.shape
    if w % 2:  # nibble plane packs two deltas per byte along the width
        return None
    if USE_NATIVE:
        from . import native

        # payoff bound doubles as an early abort: a stream that noisy can
        # never pay, so the native encoder stops as soon as it is certain
        # break-even: plane (0.5 B/px) + 1 B/entry reaches raw bytes at
        # ~0.5 entries/px; a stream past that can never pay, so the native
        # encoder aborts there rather than finishing a losing encode
        cap = windows.size if force else windows.size // 2
        plane_key = ("plane", nc, h, w // 2)
        plane_buf = _pooled(plane_key,
                            lambda: np.empty((nc, h, w // 2), np.uint8))
        res = native.wire_encode(windows, cap, plane_out=plane_buf,
                                 exc_scratch=_exc_scratch(cap))
        if res == "overflow":
            _POOL[plane_key].append(plane_buf)  # raw ships: buffer unused
            return None
        if res is not None:
            plane, flags, exc_raw, total = res
            chunk = chunk_for(windows.size)
            padded = -(-total // chunk) * chunk
            enc_bytes = plane.nbytes + padded + nc
            if not force and enc_bytes >= windows.nbytes * (1.0 - MIN_SAVING):
                _POOL[plane_key].append(plane_buf)
                return None
            exc = _pooled(("exc", padded),
                          lambda: np.empty(padded, np.uint8))
            exc[:total] = exc_raw
            exc[total:] = 0  # chunk padding: advance 0, add 0 (no-op)
            return WirePayload(
                plane=plane, exc=exc, flags=flags,
                shape=(nc, h, w),
                n_exc=int(np.count_nonzero(exc_raw & 15)),
                chunk=chunk,
            )
        # library unavailable: fall through to the NumPy twin

    a = windows.astype(np.int16)
    dv = np.diff(a, axis=1, prepend=np.zeros((nc, 1, w), np.int16))
    dh = np.diff(a, axis=2, prepend=np.zeros((nc, h, 1), np.int16))
    dg = np.diff(dv, axis=2, prepend=np.zeros((nc, h, 1), np.int16))
    rv = (dv - _signed4(dv)).astype(np.int16) & 255
    rh = (dh - _signed4(dh)).astype(np.int16) & 255
    rg = (dg - _signed4(dg)).astype(np.int16) & 255
    # per-window predictor: fewer exceptions wins (plane cost is equal);
    # argmin tie-break (first min: v < h < g) matches the C++ encoder
    counts = np.stack([np.count_nonzero(x, axis=(1, 2))
                       for x in (rv, rh, rg)])
    flags = np.argmin(counts, axis=0).astype(np.uint8)
    f = flags[:, None, None]
    d = np.where(f == 1, dh, np.where(f == 2, dg, dv))
    r = np.where(f == 1, rh, np.where(f == 2, rg, rv)).astype(np.uint8)

    # exception stream: one byte per entry, advance<<4 | residual>>4.
    # A real entry advances 1..15 px; dummy entries (low nibble 0)
    # advance 15x their nibble (15..225 px) so long gaps stay cheap.
    flat = r.reshape(-1)
    pos = np.flatnonzero(flat)
    n_exc = len(pos)
    gaps = np.diff(pos, prepend=-1)  # decoded pos = cumsum(step) - 1
    units = (gaps - 1) // 15  # 15-px units beyond the final advance
    rem = gaps - 15 * units  # final advance, in [1, 15]
    dummies = (units + 14) // 15  # each dummy carries <= 15 units
    counts = dummies + 1
    total = int(counts.sum())
    chunk = chunk_for(windows.size)
    padded = -(-total // chunk) * chunk  # 0 chunks when no exceptions

    enc_bytes = nc * h * (w // 2) + padded + nc
    if not force and enc_bytes >= windows.nbytes * (1.0 - MIN_SAVING):
        return None

    exc = np.full(padded, 0xF0, np.uint8)  # default: full 225-px dummy
    last = np.cumsum(counts) - 1
    exc[last] = (rem.astype(np.uint8) << 4) | (flat[pos] >> 4)
    # each group's first dummy carries the leftover units (1..15); it sits
    # right before the real entry, any earlier dummies stay full
    has_dummy = dummies > 0
    partial = units - 15 * (dummies - 1)
    exc[(last - 1)[has_dummy]] = partial[has_dummy].astype(np.uint8) << 4
    exc[total:] = 0  # chunk padding: advance 0, add 0 (no-op)

    nib = (d & 15).astype(np.uint8)
    plane = nib[:, :, 0::2] | (nib[:, :, 1::2] << 4)
    return WirePayload(plane=plane, exc=exc, flags=flags,
                       shape=(nc, h, w), n_exc=n_exc, chunk=chunk)


def decode_reference(payload: WirePayload) -> np.ndarray:
    """Pure-NumPy decoder: the behavioral contract the device program in
    :mod:`sykepic_tpu_torch.ops.wiredecode` is tested against."""
    nc, h, w = payload.shape
    lo = (payload.plane & 15).astype(np.int32)
    hi = (payload.plane >> 4).astype(np.int32)
    d = np.stack([lo, hi], axis=-1).reshape(nc, h, w)
    d -= 16 * (d > 7)
    adv = (payload.exc >> 4).astype(np.int64)
    v = (payload.exc & 15).astype(np.int32)
    step = np.where(v > 0, adv, adv * 15)  # dummies advance 15x
    pos = np.cumsum(step) - 1
    keep = (pos >= 0) & (pos < nc * h * w)
    np.add.at(d.reshape(-1), pos[keep], (v << 4)[keep])
    # int32 bound: |d| <= 255 per px after the scatter, so even the
    # gradient's chained cumsums stay <= npx * 255 < 2^31 for any canvas
    # the packer emits (<= 1024x1024)
    pv = np.cumsum(d, axis=1)
    ph = np.cumsum(d, axis=2)
    pg = np.cumsum(pv, axis=2)
    f = payload.flags[:, None, None]
    out = np.where(f == 1, ph, np.where(f == 2, pg, pv))
    return (out & 255).astype(np.uint8)
