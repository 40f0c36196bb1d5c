"""Ragged-ROI batching: pack variable-size ROIs into fixed-shape canvases.

XLA requires static shapes, but IFCB ROIs are ragged (typically ~180x70 px,
occasionally much larger). We bound recompilation by bucketing ROIs into a
small, fixed set of canvas sizes and packing each bucket into a
``(batch, canvas_h, canvas_w) uint8`` array (top-left placement) plus per-ROI
``(h, w)`` arrays. The device preprocessing kernel
(:mod:`sykepic_tpu_torch.ops.preprocess`) then resizes each ROI from its canvas in
one batched gather, so the host never touches pixels beyond a single memcpy
per ROI.

ROIs larger than the largest bucket are pre-shrunk on the host with an
area-preserving box filter; this only affects pathological captures (the
reference instead skips whole >1 GB samples, ``compute/probability.py:44-53``,
which we also honor at the CLI layer).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# Fixed canvas shapes, smallest-area-first (bucket_for picks the first
# fit). This legacy list is kept for callers that want a bounded, explicit
# set of compiled shapes; the default is now the *dynamic grid* below
# (buckets=None), which snaps each ROI to a fine step ladder instead.
DEFAULT_BUCKETS: tuple[tuple[int, int], ...] = (
    (32, 64),
    (48, 64),
    (64, 64),
    (64, 128),
    (96, 128),
    (128, 128),
    (96, 192),
    (128, 192),
    (128, 256),
    (192, 192),
    (256, 256),
    (256, 512),
    (512, 512),
    (512, 1024),
    (1024, 1024),
)


@dataclass
class PackedBatch:
    """One fixed-shape batch ready for device preprocessing."""

    canvas: np.ndarray  # (B, Hc, Wc) uint8
    heights: np.ndarray  # (B,) int32 -- valid ROI height per slot
    widths: np.ndarray  # (B,) int32
    roi_ids: np.ndarray  # (B,) int64 -- 1-based ROI number, 0 for padding slots
    sample_idx: np.ndarray  # (B,) int32 -- index into the caller's sample list
    n_valid: int  # number of real (non-padding) slots
    modes: np.ndarray | None = None  # (B,) uint8 -- per-ROI mode pixel
    # lossless encoded stand-in for ``canvas`` (ingest/wirecodec.py);
    # when set, the engine ships this and decodes on device (bit-exact)
    wire: object | None = None


@dataclass
class RoiBlock:
    """A whole sample's ROIs in columnar form: per-ROI geometry arrays plus
    ONE flat pixel buffer (the decoded ``.roi`` payload rides through
    untouched — ``ingest/ifcb.py:SampleRois``). The classify stream hands
    these to the shelf packer instead of per-ROI ``(sample, id, img)``
    tuples: per-ROI Python objects (generator frames, array views, ctypes
    pointers) measured ~25 us/ROI of the 1-core bench host's budget, all
    of which columnar streaming removes."""

    sample_idx: int
    roi_ids: np.ndarray  # (N,) int64, 1-based
    heights: np.ndarray  # (N,) integer
    widths: np.ndarray  # (N,) integer
    offsets: np.ndarray  # (N,) int64 byte offsets into ``base``
    base: np.ndarray  # flat uint8 pixel buffer

    def __len__(self) -> int:
        return len(self.roi_ids)

    def items(self):
        """Per-ROI ``(sample_idx, roi_id, img view)`` adapter for consumers
        that want tuples (the slot packer, the fused feature path)."""
        data = self.base
        smp = self.sample_idx
        ids = np.asarray(self.roi_ids).tolist()
        hs = np.asarray(self.heights).tolist()
        npx = (np.asarray(self.heights, np.int64)
               * np.asarray(self.widths, np.int64)).tolist()
        ss = np.asarray(self.offsets).tolist()
        for rid, h, n, s in zip(ids, hs, npx, ss):
            yield smp, rid, data[s : s + n].reshape(h, n // h)


def roi_items(stream):
    """Normalize a mixed stream of :class:`RoiBlock` s and per-ROI tuples
    into per-ROI tuples (pass-through for tuples)."""
    for item in stream:
        if isinstance(item, RoiBlock):
            yield from item.items()
        else:
            yield item


# The dynamic grid's largest canvas side; anything bigger is host-shrunk.
GRID_MAX = 1024


def snap_dim(x: int) -> int:
    """Snap a ROI side up to the dynamic-grid ladder: 8-px steps to 64,
    16 to 128, 32 to 256, then 64. Fine where the ROI volume lives (IFCB
    captures are mostly ~30x55 px), coarse where a new compiled shape
    would cost more than the padding it saves."""
    if x <= 64:
        step = 8
    elif x <= 128:
        step = 16
    elif x <= 256:
        step = 32
    else:
        step = 64
    return min(-(-x // step) * step, GRID_MAX)


def mode_pixel(img: np.ndarray) -> int:
    """Most common pixel value of one image — the reference's border fill
    (``image.py:229-237``: cv2.calcHist 256 bins + argmax, first-max wins).
    THE single definition: both packers and ``ops/preprocess`` use it, so
    the slot and shelf paths cannot drift apart on border semantics.
    Runs in C++ when the native library is available (same first-max
    histogram argmax; the NumPy line below is the contract)."""
    arr = np.asarray(img, np.uint8)
    if arr.flags.c_contiguous:
        from . import native

        mode = native.u8_mode(arr)
        if mode is not None:
            return mode
    return int(np.bincount(arr.ravel(), minlength=256).argmax())


def batch_modes(imgs, heights, widths, ptrs=None) -> np.ndarray:
    """Mode pixel per (contiguous uint8) ROI, one native call for the
    whole batch — per-ROI ctypes round trips dominate the histograms
    themselves. The NumPy fallback keeps the single border definition
    (:func:`mode_pixel`). Shared by both packers' emit paths; ``ptrs``
    optionally reuses a prebuilt ``native.img_ptrs(imgs)`` array."""
    from . import native

    got = native.u8_modes(imgs, heights, widths, ptrs=ptrs)
    if got is None:
        got = np.fromiter((mode_pixel(im) for im in imgs),
                          np.uint8, len(imgs))
    return got


def bucket_for(h: int, w: int, buckets=None) -> tuple[int, int]:
    """Canvas shape for an (h, w) ROI.

    With ``buckets=None`` (the default) the shape comes from the dynamic
    grid (:func:`snap_dim` per side): padding bytes are the measured
    bottleneck over a host link, and the fine ladder ships ~35% fewer
    bytes than the legacy fixed list on real IFCB size mixes. Each
    distinct snapped shape compiles once (persistently cached on disk).
    With an explicit bucket list: the smallest bucket that fits, or the
    largest bucket if none do.
    """
    if buckets is None:
        return snap_dim(h), snap_dim(w)
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return (bh, bw)
    return buckets[-1]


def shrink_to_fit(img: np.ndarray, max_h: int, max_w: int) -> np.ndarray:
    """Downscale an oversized ROI to fit (max_h, max_w), keeping aspect, with
    :func:`resize_area_u8` (bit-exact with cv2's INTER_AREA, as the JAX
    package resizes here). The fused pass does not pre-shrink, so a ROI over
    ``GRID_MAX`` on a side reaches this."""
    h, w = img.shape
    scale = min(max_h / h, max_w / w)
    new_h = max(1, int(h * scale))
    new_w = max(1, int(w * scale))
    return resize_area_u8(img, new_h, new_w)


def _area_taps(src: int, dst: int, scale: float):
    """Per-axis taps of OpenCV's INTER_AREA decimation
    (``computeResizeAreaTab``): ``(si, alpha)`` as ``(dst, T)`` arrays in
    cv2's summation order, padded with weight 0 (adding +0.0 changes no
    float sum). Cell edges in double, weights rounded to float32."""
    taps = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row.extend((sx, 1.0 / cell) for sx in range(sx1, sx2))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    t = max(len(r) for r in taps)
    si = np.zeros((dst, t), np.int64)
    alpha = np.zeros((dst, t), np.float32)
    for dx, row in enumerate(taps):
        for k, (s, a) in enumerate(row):
            si[dx, k], alpha[dx, k] = s, a
    return si, alpha


def resize_area_u8(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bit-exact twin of ``cv2.resize(img, (new_w, new_h),
    interpolation=cv2.INTER_AREA)`` for a 2-D uint8 downscale (held against
    cv2 in the tests). Integer factors take cv2's fast path: the integer
    box sum, ``(sum + 2) >> 2`` at 2x2, else ``rint(float32(sum) *
    float32(1 / area))``. Other factors take the area-weighted path: each
    source row summed across in float32 with the x weights, the rows summed
    down with the y weights, each in cv2's order, then rounded half to
    even."""
    h, w = img.shape
    if new_h > h or new_w > w or new_h < 1 or new_w < 1:
        raise ValueError(f"resize_area_u8 only downscales: ({h}, {w}) -> "
                         f"({new_h}, {new_w})")
    if (new_h, new_w) == (h, w):
        return img.copy()
    scale_x, scale_y = 1.0 / (new_w / w), 1.0 / (new_h / h)
    ix, iy = round(scale_x), round(scale_y)
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        box = img[:new_h * iy, :new_w * ix].astype(np.int32).reshape(
            new_h, iy, new_w, ix).sum(axis=(1, 3))
        if ix == 2 and iy == 2:
            return ((box + 2) >> 2).astype(np.uint8)
        out = np.rint(box.astype(np.float32)
                      * (np.float32(1) / np.float32(ix * iy)))
        return np.clip(out, 0, 255).astype(np.uint8)
    sx, ax = _area_taps(w, new_w, scale_x)
    sy, ay = _area_taps(h, new_h, scale_y)
    src = img.astype(np.float32)
    rows = np.zeros((h, new_w), np.float32)
    for k in range(sx.shape[1]):
        rows += src[:, sx[:, k]] * ax[:, k]
    out = np.zeros((new_h, new_w), np.float32)
    for k in range(sy.shape[1]):
        out += rows[sy[:, k]] * ay[:, k, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _linear_taps(src: int, dst: int):
    """Per-axis source taps and 11-bit fixed-point weights of OpenCV's
    uint8 INTER_LINEAR resize: ``(s0, s1, c0, c1)`` int32 arrays of length
    ``dst``. Same float steps as cv2 (coordinate in double, then float32
    floor / fraction, edge clamp, ``rint(f * 2048)``)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int32)
    low = s < 0
    s[low] = 0
    f[low] = 0
    high = s >= src - 1
    s[high] = src - 1
    f[high] = 0
    c1 = np.rint(f * np.float32(2048)).astype(np.int32)
    c0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    return s, np.minimum(s + 1, src - 1), c0, c1


def resize_linear_u8(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bit-exact twin of ``cv2.resize(img, (new_w, new_h),
    interpolation=cv2.INTER_LINEAR)`` for a 2-D uint8 image (held against
    cv2 in the tests). Horizontal pass in int32 with 11-bit weights, then
    the vertical pass rounded the way cv2's SIMD path rounds it on every
    column: ``((r0>>4)*b0>>16) + ((r1>>4)*b1>>16) + 2 >> 2``."""
    h, w = img.shape
    sx0, sx1, cx0, cx1 = _linear_taps(w, new_w)
    sy0, sy1, cy0, cy1 = _linear_taps(h, new_h)
    src = img.astype(np.int32)
    rows = src[:, sx0] * cx0 + src[:, sx1] * cx1  # (h, new_w)
    r0 = rows[sy0] >> 4
    r1 = rows[sy1] >> 4
    out = (((r0 * cy0[:, None]) >> 16) + ((r1 * cy1[:, None]) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


# Cap per-batch canvas memory: a full batch of (1024, 1024) slots at
# batch_size 512 would be a 0.5 GB host allocation (and H2D transfer).
# Large-ROI buckets get proportionally smaller (power-of-two) batch sizes;
# each (bucket, batch) pair stays one shape.
MAX_CANVAS_BYTES = 32 * 1024 * 1024


def target_resize_dims(h: int, w: int, target_h: int, target_w: int):
    """Aspect-preserving resize dims for one ROI — the same float64
    multiply-then-truncate as :func:`ops.preprocess.compute_geometry`
    (reference ``image.py:183-198``), so a host-side pre-shrink lands on
    exactly the dims the device resize would have produced (a fixed point:
    re-applying the formula returns the same dims)."""
    if h > w:
        return target_h, max(1, int(w * (target_h / h)))
    return max(1, int(h * (target_w / w))), target_w


def shrunk_dims(h: int, w: int, target_h: int, target_w: int):
    """Dims after :func:`pre_shrink`: the aspect-preserving target dims if
    they shrink the image, else the original dims. The single definition of
    the "only ever downscale" decision — used by both the shrink itself and
    size-sort keys that must predict it without decoding pixels."""
    new_h, new_w = target_resize_dims(h, w, target_h, target_w)
    if new_h >= h and new_w >= w:
        return h, w
    return new_h, new_w


def pre_shrink(img: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Host-side downscale of ROIs larger than the model target.

    The device preprocess resizes every ROI to its aspect-preserving target
    anyway; for ROIs LARGER than the target that is a downsample, so doing
    it on the host (cv2 INTER_LINEAR — the reference's own kernel,
    ``train/image.py:201-226``) transfers up to ~8x fewer bytes over the
    link and turns the device resize into an identity sampling. Small ROIs
    are never touched (host upscaling would inflate bytes). The downscale
    is :func:`resize_linear_u8`, bit-exact with cv2 INTER_LINEAR, which the
    card's host does not have.
    """
    h, w = img.shape
    if h <= target_h and w <= target_w:
        # fast reject for the ~97% of real-mix ROIs already at or under
        # the target: scale >= 1 on the driving side, so shrunk_dims
        # provably returns (h, w) -- skip the per-ROI float math (it was
        # ~5 us/ROI of the classify stream's host budget)
        return img
    new_h, new_w = shrunk_dims(h, w, target_h, target_w)
    if (new_h, new_w) == (h, w):
        return img
    return resize_linear_u8(img, new_h, new_w)


def effective_batch_size(batch_size: int, bucket: tuple[int, int],
                         max_bytes: int = MAX_CANVAS_BYTES,
                         multiple: int = 1) -> int:
    """Batch size for a bucket under the canvas-memory cap, rounded up to
    ``multiple`` (a data-parallel mesh needs every batch divisible by its
    device count)."""
    slot = bucket[0] * bucket[1]
    b = batch_size
    while b > 1 and b * slot > max_bytes:
        b //= 2
    b = max(b, 1, multiple)
    return ((b + multiple - 1) // multiple) * multiple


def pack_rois(
    rois,
    batch_size: int = 256,
    buckets=None,
    pad_to_batch: bool = True,
    batch_multiple: int = 1,
    pre_shrink_to: tuple[int, int] | None = None,
    compute_modes: bool = False,
    consolidate_tails: bool = True,
):
    """Group ROIs by bucket and pack them into :class:`PackedBatch` es.

    Parameters
    ----------
    rois : iterable of (sample_idx, roi_id, np.ndarray)
        Decoded ROIs (2-D uint8 arrays) tagged with their origin.
    batch_size : int
        Fixed batch size per canvas shape. The tail batch is zero-padded up to
        this size when ``pad_to_batch`` so every (canvas, batch) shape pair
        compiles exactly once.
    compute_modes : bool
        Also compute each ROI's mode pixel (``PackedBatch.modes``) from its
        real pixels while they are cache-hot. A 256-bin bincount over the
        ROI's own bytes costs ~5 us here versus ~10x that when recovered
        later from the padded canvas (the old ``mode_pixel_batch`` path
        scaled with canvas bytes, not ROI bytes).

    Yields
    ------
    PackedBatch
    """
    groups: dict[tuple[int, int], list] = {}
    for sample_idx, roi_id, img in rois:
        if pre_shrink_to is not None:
            img = pre_shrink(img, pre_shrink_to[0], pre_shrink_to[1])
        bh, bw = bucket_for(img.shape[0], img.shape[1], buckets)
        if img.shape[0] > bh or img.shape[1] > bw:
            img = shrink_to_fit(img, bh, bw)
        group = groups.setdefault((bh, bw), [])
        group.append((sample_idx, roi_id, img))
        if len(group) == effective_batch_size(batch_size, (bh, bw),
                                              multiple=batch_multiple):
            yield _emit(group, bh, bw, len(group), pad_to_batch, compute_modes)
            groups[(bh, bw)] = []
    # Tail consolidation: at stream end every bucket shape holds a partial
    # batch, and each would ship a pow2-padded tail of mostly EMPTY slots
    # (measured ~12% of all shipped bytes on a realistic mix with ~90
    # shapes in play). Migrating a small group's ROIs into the tail of a
    # LARGER canvas costs extra per-ROI padding but can erase a whole
    # padded tail batch; do it whenever the exact shipped-byte accounting
    # says it is cheaper. Uses only canvas shapes already in play, so the
    # compiled-shape set never grows.
    #
    # ``consolidate_tails=False`` opts a caller out: migrating a ROI to a
    # bigger canvas changes its FFT window, so the fused on-device FEATURE
    # path (whose segmentation is window-sensitive, ops/features_device.py)
    # keeps every ROI on its own snapped canvas — otherwise feature values
    # would depend on the mesh's batch_multiple. Classification is
    # window-invariant (the resize einsums sample only [0,h)x[0,w)), so
    # the default stays on for the pure classify path.
    min_piece = max(batch_multiple, 1)

    def _tail_slots(n: int, shape: tuple[int, int]) -> int:
        """Shipped slots for an n-item leftover at ``shape``: the same
        :func:`_tail_pieces` walk the emission loop uses, summed —
        consolidation decisions and actual emission cannot drift apart."""
        full = effective_batch_size(batch_size, shape, multiple=batch_multiple)
        return sum(piece for piece, _ in _tail_pieces(n, full, min_piece))

    keys = (sorted((k for k in groups if groups[k]),
                   key=lambda k: (k[0] * k[1], k))
            if consolidate_tails else [])
    for i, key in enumerate(keys):
        group = groups[key]
        if not group:
            continue
        fits = [k for k in keys[i + 1:]
                if k[0] >= key[0] and k[1] >= key[1] and groups[k]]
        if not fits:
            continue
        target = min(fits, key=lambda k: k[0] * k[1])
        s_area = key[0] * key[1]
        t_area = target[0] * target[1]
        separate = (_tail_slots(len(group), key) * s_area
                    + _tail_slots(len(groups[target]), target) * t_area)
        merged = _tail_slots(len(group) + len(groups[target]), target) * t_area
        if merged < separate:
            groups[target].extend(group)
            groups[key] = []

    for (bh, bw), group in groups.items():
        if not group:
            continue
        full = effective_batch_size(batch_size, (bh, bw),
                                    multiple=batch_multiple)
        pos = 0
        for piece, real in _tail_pieces(len(group), full, min_piece):
            yield _emit(group[pos : pos + real], bh, bw, piece,
                        pad_to_batch, compute_modes)
            pos += real


def _tail_pieces(n: int, full: int, min_piece: int):
    """Emitted ``(batch_size, real_items)`` sequence for an ``n``-item
    group: full batches first, then the power-of-two tail ladder.

    Tail batches ride the ladder (``min_piece * 2**k``) so the set of
    compiled (canvas, batch) shapes stays small and stable — never a
    halved ``full`` rounded to a multiple, which minted off-ladder sizes
    (e.g. 126) when ``full`` is not itself a ladder value. A single
    padded pow2 batch can still ship up to 2x its real bytes
    (1025 -> 2048), so large tails SPLIT into descending pieces
    (1200 -> 1024 + 128 + 64): same ladder, <7% padding. This generator
    is the single source of truth for both emission and the tail-
    consolidation byte accounting above."""
    while n > 0:
        if n >= full:
            yield full, full
            n -= full
            continue
        pow2 = min_piece
        while pow2 < n:
            pow2 *= 2
        pow2 = min(pow2, full)
        piece = min_piece
        while piece * 2 < pow2:
            piece *= 2
        if pow2 - n > 64 and pow2 > 128 and 0 < piece < n:
            yield piece, piece
            n -= piece
        else:
            yield pow2, n
            n = 0


def _emit(group, bh, bw, batch_size, pad_to_batch,
          compute_modes=False) -> PackedBatch:
    n = len(group)
    b = batch_size if pad_to_batch else n
    canvas = np.zeros((b, bh, bw), dtype=np.uint8)
    heights = np.ones(b, dtype=np.int32)
    widths = np.ones(b, dtype=np.int32)
    roi_ids = np.zeros(b, dtype=np.int64)
    sample_idx = np.zeros(b, dtype=np.int32)
    modes = np.zeros(b, dtype=np.uint8) if compute_modes else None
    for i, (sidx, rid, img) in enumerate(group):
        h, w = img.shape
        canvas[i, :h, :w] = img
        heights[i] = h
        widths[i] = w
        roi_ids[i] = rid
        sample_idx[i] = sidx
    if modes is not None and n:
        imgs = [img if img.flags.c_contiguous else np.ascontiguousarray(img)
                for _, _, img in group]
        modes[:n] = batch_modes(imgs, heights[:n], widths[:n])
    return PackedBatch(canvas, heights, widths, roi_ids, sample_idx,
                       n_valid=n, modes=modes)
