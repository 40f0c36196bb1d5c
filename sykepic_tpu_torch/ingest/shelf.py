"""2-D shelf packing: many ROIs per canvas window, exact widths.

The slot packer (:mod:`sykepic_tpu_torch.ingest.pack`) gives every ROI its own
snapped canvas; on the wire that costs ~19% height/width snap padding plus
~6% empty tail slots on realistic IFCB size mixes (measured in bench.py's
byte accounting — and the link, not the chip, bounds end-to-end inference
throughput over a host link). This module packs ROIs side by side into
fixed ``(WIN_H, WIN_W)`` uint8 windows instead:

- ROIs are grouped into *shelves* (rows of near-equal height, exact widths,
  left to right), shelves stack into windows, windows stack into one
  ``(Nc, WIN_H, WIN_W)`` tensor per dispatch. Measured shipped bytes on the
  realistic bench mix drop from ~4.4 KB/ROI (slot packer) to ~3.7 KB/ROI —
  within a few percent of the raw pixel floor.
- Every dispatch compiles against ONE window shape; only the (padded)
  window count and slot count vary, each on a coarse ladder, so the whole
  stream runs through a handful of compiled programs instead of one per
  snapped canvas shape.

The device side extracts each ROI straight out of its window inside the
resize einsum via row/column origins (``ops/preprocess.py``) — no crop is
ever materialized, and classification output is bit-comparable to the slot
path (same geometry metadata, same bilinear taps).

Feature extraction is window-sensitive (FFT over the canvas), so the fused
classify+features path keeps the slot packer; shelf packing is for the
pure classification stream (reference workload:
``sykepic/compute/probability.py:133-206``).
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass

import numpy as np

from . import pack

WIN_H = 192  # fits any pre-shrunk ROI (<= network input, <= 180) plus slack
WIN_W = 512
NC_FULL = 64  # windows per full dispatch (~6.3 MB on the wire)
SLOT_CAP = 4096  # hard slot bound per dispatch (tiny-ROI floods)

# Ladders keep the set of compiled (window-count, slot-count) programs
# small: a value is padded UP to the next rung (zero windows ship a few
# hundred KB once per stream end; padding slots costs device compute only).
NC_LADDER = (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64)
SLOT_STEP = 256
SLOT_MIN = 64


def pad_nc(n: int) -> int:
    for v in NC_LADDER:
        if n <= v:
            return v
    return NC_LADDER[-1]


def _slot_rungs(multiple: int) -> tuple[int, int]:
    """(base, step) of the padded-slot ladder for a batch multiple: padded
    sizes are ``base`` (= lcm(SLOT_MIN, multiple)) or multiples of ``step``
    (= lcm(SLOT_STEP, multiple)); SLOT_MIN | SLOT_STEP so base | step."""
    base = SLOT_MIN
    while base % multiple:
        base += SLOT_MIN
    step = SLOT_STEP
    while step % multiple:
        step += SLOT_STEP
    return base, step


def pad_slots(n: int, multiple: int = 1) -> int:
    base, step = _slot_rungs(multiple)
    if n <= base:
        return base
    return -(-n // step) * step


def floor_slots(cap: int, multiple: int = 1) -> int:
    """Largest pad_slots output <= ``cap`` — the effective per-dispatch
    slot bound a caller's cap admits (a dispatch packed to this count pads
    to exactly this count, never past the cap)."""
    base, step = _slot_rungs(multiple)
    best = (cap // step) * step
    if best >= base:
        return best
    if base <= cap:
        return base
    raise ValueError(
        f"slot cap {cap} is below the smallest padded dispatch "
        f"({base} for batch multiple {multiple})"
    )


@dataclass
class ShelfBatch:
    """One dispatch: ``windows`` holds the pixels, the per-slot arrays say
    where each ROI lives (window index + origin) and what it is."""

    windows: np.ndarray  # (Nc, WIN_H, WIN_W) uint8
    win_idx: np.ndarray  # (R,) int32
    y0: np.ndarray  # (R,) int32 -- row origin inside the window
    x0: np.ndarray  # (R,) int32
    heights: np.ndarray  # (R,) int32
    widths: np.ndarray  # (R,) int32
    roi_ids: np.ndarray  # (R,) int64
    sample_idx: np.ndarray  # (R,) int32
    n_valid: int
    modes: np.ndarray | None = None  # (R,) uint8
    # lossless encoded stand-in for ``windows`` (ingest/wirecodec.py);
    # when set, the engine ships this instead of the raw tensor and
    # decodes on device — bit-identical windows, ~1.5x fewer wire bytes
    wire: object | None = None


class _Shelver:
    """Greedy height-sorted shelf packing of a buffered ROI set.

    First-fit-decreasing-height: shelves open at the tallest pending
    height that fits the window's free rows, fill left to right preferring
    the tallest ROI whose width fits (heights adjacent in sorted order, so
    in-shelf headroom stays small), and windows close when no pending ROI
    fits the remaining rows.

    The placement loop is the host-side hot path of the classify stream,
    so it runs in C++ when the native library is available
    (``native.shelf_pack`` — the same algorithm, asserted equivalent in
    ``tests/test_torch_shelf.py``); the Python path below is the documented
    fallback and the behavioral contract.
    """

    def __init__(self, heights: np.ndarray, widths: np.ndarray):
        # columnar pending set: parallel (height, width) arrays
        self.h = np.ascontiguousarray(heights, np.int32)
        self.w = np.ascontiguousarray(widths, np.int32)
        self.alive = np.ones(len(self.h), bool)
        self._python_ready = False
        from . import native as _native

        self._native = _native if _native.lib() is not None else None

    # -- shared state ------------------------------------------------------

    def pending(self) -> bool:
        return bool(self.alive.any())

    def pending_order(self) -> np.ndarray:
        """Pending item indices in pack preference order (height desc,
        width desc, insertion order) — the order ``flush`` re-buffers
        leftovers in so carried sets keep packing identically."""
        idx = np.flatnonzero(self.alive)
        order = np.lexsort((-self.w[idx], -self.h[idx]))
        return idx[order].astype(np.int64)

    def pack(self, max_windows: int, max_slots: int):
        """Place ROIs into up to ``max_windows`` windows.

        Returns ``(placements, n_windows)`` where placements is a tuple of
        int32 arrays ``(item_index, win, y0, x0)``. Unplaced items stay
        pending.
        """
        if self._native is not None:
            idx = np.flatnonzero(self.alive).astype(np.int32)
            res = self._native.shelf_pack(
                self.h[idx], self.w[idx], WIN_H, WIN_W,
                max_windows, max_slots,
            )
            if res is not None:
                item, win, y0, x0, n_windows = res
                orig = idx[item]
                self.alive[orig] = False
                return (orig, win, y0, x0), n_windows
            self._native = None  # load raced/failed: fall back for good
        return self._pack_python(max_windows, max_slots)

    # -- pure-Python fallback (the reference semantics) --------------------

    def _ensure_python(self):
        if self._python_ready:
            return
        by_height: dict[int, list[int]] = {}
        for i in np.flatnonzero(self.alive):
            by_height.setdefault(int(self.h[i]), []).append(int(i))
        # per-height index lists sorted by width DESC (widest-first keeps
        # the narrow ROIs for plugging right-edge gaps)
        for h, idxs in by_height.items():
            idxs.sort(key=lambda i: -int(self.w[i]))
        self.by_height = by_height
        self.heights_desc = sorted(by_height, reverse=True)
        self._python_ready = True

    def _take(self, max_h: int, max_w: int):
        """Pop the tallest pending ROI with h <= max_h and width <= max_w."""
        for h in self.heights_desc:
            if h > max_h:
                continue
            idxs = self.by_height.get(h)
            if not idxs:
                continue
            # idxs sorted by width desc: first fitting one is the widest
            for k, i in enumerate(idxs):
                if self.w[i] <= max_w:
                    del idxs[k]
                    self.alive[i] = False
                    return i
        return None

    def _pack_python(self, max_windows: int, max_slots: int):
        self._ensure_python()
        placements = []
        win = 0
        while win < max_windows and self.pending():
            free_y = 0
            while free_y < WIN_H:
                first = self._take(WIN_H - free_y, WIN_W)
                if first is None:
                    break  # nothing fits the leftover rows
                shelf_h = int(self.h[first])
                x = int(self.w[first])
                placements.append((first, win, free_y, 0))
                while x < WIN_W:
                    if len(placements) >= max_slots:
                        break
                    nxt = self._take(shelf_h, WIN_W - x)
                    if nxt is None:
                        break
                    placements.append((nxt, win, free_y, x))
                    x += int(self.w[nxt])
                free_y += shelf_h
                if len(placements) >= max_slots:
                    break
            win += 1
            if len(placements) >= max_slots:
                break
        cols = (np.array([p[i] for p in placements], np.int32)
                for i in range(4))
        return tuple(cols), win


# Window-tensor pool, keyed by padded window count: recycling a drained
# dispatch's 6.3 MB buffer makes the cost a fill instead of fresh mmap page
# faults for the whole tensor. deque append/pop are GIL-atomic; the
# capacity tracks the engine's in-flight pipeline depths (utils/depths.py)
# plus slack, so neither queue can overflow the pool and silently drop
# buffers back to the page-fault path.
from ..utils.depths import FUSED_PIPELINE_DEPTH, PIPELINE_DEPTH

POOL_CAP = max(PIPELINE_DEPTH, FUSED_PIPELINE_DEPTH) + 4
_WINDOW_POOL: dict[int, deque] = defaultdict(lambda: deque(maxlen=POOL_CAP))


def _window_buffer(nc: int, fill: int) -> np.ndarray:
    try:
        buf = _WINDOW_POOL[nc].pop()
    except IndexError:
        return np.full((nc, WIN_H, WIN_W), fill, np.uint8)
    buf.fill(fill)
    return buf


def recycle_windows(batch: "ShelfBatch") -> None:
    """Return a drained batch's window tensor to the pool. Callers must
    guarantee nothing reads ``batch.windows`` afterwards — the engine
    calls this from its drain stage, where the device result for the
    dispatch has already arrived (so even a raw, codec-gated-off upload
    of this exact buffer has completed)."""
    w = batch.windows
    if (w is not None and w.dtype == np.uint8
            and w.ndim == 3 and w.shape[1:] == (WIN_H, WIN_W)):
        _WINDOW_POOL[w.shape[0]].append(w)
    batch.windows = None


class _Cols:
    """Columnar pending-ROI buffer segment: parallel per-ROI arrays. Pixel
    bytes stay in the caller-owned ``bases`` list; each ROI points at its
    C-contiguous run via ``(buf_idx, offset)``. No per-ROI Python objects
    exist anywhere in this representation — the point of the design."""

    __slots__ = ("sample", "roi_ids", "h", "w", "bi", "off", "fp")

    def __init__(self, sample, roi_ids, h, w, bi, off, fp):
        self.sample = sample  # (N,) int32
        self.roi_ids = roi_ids  # (N,) int64
        self.h = h  # (N,) int32
        self.w = w  # (N,) int32
        self.bi = bi  # (N,) int32 index into bases
        self.off = off  # (N,) int64 byte offset into bases[bi]
        self.fp = fp  # (N,) uint8 first (corner) pixel — fill heuristic

    def __len__(self) -> int:
        return len(self.h)

    @staticmethod
    def concat(segs: list["_Cols"]) -> "_Cols":
        if len(segs) == 1:
            return segs[0]
        return _Cols(*(np.concatenate([getattr(s, f) for s in segs])
                       for f in _Cols.__slots__))

    def take(self, idx) -> "_Cols":
        return _Cols(*(getattr(self, f)[idx] for f in _Cols.__slots__))


def _emit(cols: _Cols, bases: list, placements, n_windows,
          batch_multiple, compute_modes):
    item, win, y, x = placements
    k = len(item)
    nc = pad_nc(n_windows)
    r = pad_slots(k, batch_multiple)
    # Padding is semantically dead (the resize einsums read only each
    # ROI's origin-shifted region), but the wire codec encodes the WHOLE
    # window, so fill with the batch's median corner pixel instead of
    # zero: IFCB backgrounds are near-uniform gray, and a near-background
    # fill keeps padding deltas and most ROI-edge crossings inside the
    # 4-bit plane (measured 13 B/ROI fewer codec exceptions on the bench
    # mix — small because intra-shelf ROI-to-ROI boundaries dominate).
    fill = int(np.median(cols.fp[item])) if k else 0
    windows = _window_buffer(nc, fill)
    win_idx = np.zeros(r, np.int32)
    y0 = np.zeros(r, np.int32)
    x0 = np.zeros(r, np.int32)
    heights = np.ones(r, np.int32)
    widths = np.ones(r, np.int32)
    roi_ids = np.zeros(r, np.int64)
    sample_idx = np.zeros(r, np.int32)
    modes = np.zeros(r, np.uint8) if compute_modes else None

    win_idx[:k] = win
    y0[:k] = y
    x0[:k] = x
    heights[:k] = cols.h[item]
    widths[:k] = cols.w[item]
    roi_ids[:k] = cols.roi_ids[item]
    sample_idx[:k] = cols.sample[item]
    bsel = cols.bi[item]
    osel = cols.off[item]

    from . import native as _native

    # one native pass blits every ROI out of its decode buffer AND (when
    # asked) computes its mode pixel while the bytes are cache-hot
    res = (_native.shelf_blit_blocks(
        bases, bsel, osel, heights[:k], widths[:k],
        win_idx[:k], y0[:k], x0[:k], windows, want_modes=compute_modes,
    ) if k else True)
    if res is None:  # pure-NumPy fallback (no native library)
        views = []
        for s in range(k):
            h, wd = int(heights[s]), int(widths[s])
            o = int(osel[s])
            im = bases[int(bsel[s])][o : o + h * wd].reshape(h, wd)
            views.append(im)
            windows[win_idx[s], y0[s]:y0[s] + h, x0[s]:x0[s] + wd] = im
        if modes is not None and k:
            modes[:k] = pack.batch_modes(views, heights[:k], widths[:k])
    elif compute_modes and k:
        modes[:k] = res
    return ShelfBatch(
        windows=windows, win_idx=win_idx, y0=y0, x0=x0,
        heights=heights, widths=widths, roi_ids=roi_ids,
        sample_idx=sample_idx, n_valid=k, modes=modes,
    )


def pack_shelves(
    rois,
    pre_shrink_to: tuple[int, int],
    batch_multiple: int = 1,
    compute_modes: bool = False,
    nc_full: int = NC_FULL,
    slot_cap: int = SLOT_CAP,
):
    """Stream ROIs into :class:`ShelfBatch` dispatches.

    ``rois`` yields :class:`sykepic_tpu_torch.ingest.pack.RoiBlock` s (columnar —
    the zero-per-ROI-Python hot path the classify stream uses) and/or
    per-ROI ``(sample_idx, roi_id, uint8 image)`` tuples (the compatibility
    surface; converted to small columnar segments internally).

    ROIs buffer until roughly one full dispatch of pixels is pending, are
    shelf-packed as a set (sorting needs the set), and anything the packer
    could not place in ``nc_full`` windows carries into the next buffer.
    ``pre_shrink_to`` is mandatory: windows are sized for ROIs no larger
    than the network input (the classify path host-shrinks oversized ROIs
    anyway — :meth:`Classifier.classify_rois`).
    """
    target_h, target_w = pre_shrink_to
    if target_h > WIN_H or target_w > WIN_W:
        raise ValueError(
            f"pre-shrink target {pre_shrink_to} exceeds the shelf window "
            f"({WIN_H}, {WIN_W})"
        )
    if nc_full > NC_LADDER[-1]:
        # pad_nc clamps to the ladder; a larger nc_full would overflow the
        # window tensor _emit allocates
        raise ValueError(
            f"nc_full {nc_full} exceeds the window-count ladder "
            f"(max {NC_LADDER[-1]})"
        )
    # snap nc_full DOWN to a ladder rung: an off-ladder value would make
    # EVERY full dispatch pad up to the next rung and ship permanently
    # dead windows over the link (the e2e throughput bound)
    nc_full = max(v for v in NC_LADDER if v <= max(nc_full, 1))
    # floor the slot cap to a padded-ladder value so _emit's pad_slots
    # never rounds a full dispatch ABOVE the caller's cap (the cap exists
    # to bound the per-dispatch device working set)
    slot_cap = floor_slots(slot_cap, batch_multiple)
    # flush when buffered pixels would fill ~all of a dispatch's windows
    flush_bytes = int(nc_full * WIN_H * WIN_W * 0.98)
    win_bytes = WIN_H * WIN_W
    next_flush = flush_bytes
    segs: list[_Cols] = []  # columnar buffer segments, arrival order
    bases: list[np.ndarray] = []  # pixel buffers the segments point into
    pending_items: list = []  # per-ROI tuples awaiting columnarization
    buffered_bytes = 0
    buffered_n = 0

    def _shrink_overflow(cols_h, cols_w, off, bi, fp, base):
        """Host-shrink every ROI above the network target (or the window)
        in one exception pass; their bytes move to a fresh base buffer.
        Mutates the column arrays in place, returns added pixel bytes."""
        big = np.flatnonzero((cols_h > target_h) | (cols_w > target_w))
        if not len(big):
            return 0
        imgs = []
        for j in big.tolist():
            o = int(off[j])
            hh, ww = int(cols_h[j]), int(cols_w[j])
            im = pack.pre_shrink(base[o : o + hh * ww].reshape(hh, ww),
                                 target_h, target_w)
            if im.shape[0] > WIN_H or im.shape[1] > WIN_W:
                im = pack.shrink_to_fit(im, WIN_H, WIN_W)
            imgs.append(np.ascontiguousarray(im))
        extra = np.concatenate([im.reshape(-1) for im in imgs])
        sizes = np.fromiter((im.size for im in imgs), np.int64, len(imgs))
        eoff = np.zeros(len(imgs), np.int64)
        np.cumsum(sizes[:-1], out=eoff[1:])
        ebid = len(bases)
        bases.append(extra)
        cols_h[big] = [im.shape[0] for im in imgs]
        cols_w[big] = [im.shape[1] for im in imgs]
        off[big] = eoff
        bi[big] = ebid
        fp[big] = extra[eoff]
        return int(extra.size)

    def append_block(blk: pack.RoiBlock):
        nonlocal buffered_bytes, buffered_n
        n = len(blk)
        if n == 0:
            return
        base = blk.base
        if base.ndim != 1 or not base.flags.c_contiguous:
            base = np.ascontiguousarray(base).reshape(-1)
        h = np.asarray(blk.heights).astype(np.int32)
        w = np.asarray(blk.widths).astype(np.int32)
        off = np.asarray(blk.offsets).astype(np.int64)
        npx = h.astype(np.int64) * w
        if int((off + npx).max()) > base.size or int(off.min()) < 0:
            raise ValueError(
                "RoiBlock geometry points outside its pixel buffer"
            )
        bid = len(bases)
        bases.append(base)
        bi = np.full(n, bid, np.int32)
        fp = base[off]
        extra_bytes = _shrink_overflow(h, w, off, bi, fp, base)
        segs.append(_Cols(
            sample=np.full(n, blk.sample_idx, np.int32),
            roi_ids=np.asarray(blk.roi_ids, np.int64),
            h=h, w=w, bi=bi, off=off, fp=fp,
        ))
        buffered_bytes += int(h.astype(np.int64) @ w)
        buffered_n += n

    def convert_pending():
        """Columnarize buffered per-ROI tuples (already pre-shrunk at
        append time) into one segment; each image is its own base."""
        nonlocal pending_items
        if not pending_items:
            return
        n = len(pending_items)
        h = np.fromiter((im.shape[0] for _, _, im in pending_items),
                        np.int32, n)
        w = np.fromiter((im.shape[1] for _, _, im in pending_items),
                        np.int32, n)
        bi = np.arange(len(bases), len(bases) + n, dtype=np.int32)
        fp = np.fromiter((im[0, 0] for _, _, im in pending_items),
                         np.uint8, n)
        for _, _, im in pending_items:
            bases.append(im.reshape(-1) if im.flags.c_contiguous
                         else np.ascontiguousarray(im).reshape(-1))
        segs.append(_Cols(
            sample=np.fromiter((s for s, _, _ in pending_items),
                               np.int32, n),
            roi_ids=np.fromiter((r for _, r, _ in pending_items),
                                np.int64, n),
            h=h, w=w, bi=bi, off=np.zeros(n, np.int64), fp=fp,
        ))
        pending_items = []

    def flush(final: bool):
        nonlocal segs, bases, buffered_bytes, buffered_n, next_flush
        convert_pending()
        cols = _Cols.concat(segs)
        shelver = _Shelver(cols.h, cols.w)
        out = []
        carried = np.zeros(0, np.int64)  # packed but not emitted
        short = 0  # windows short of a full dispatch when carrying
        while True:
            placements, n_windows = shelver.pack(nc_full, slot_cap)
            if len(placements[0]) == 0:
                break
            full = (n_windows >= nc_full
                    or len(placements[0]) >= slot_cap)
            if final or full:
                out.append(_emit(cols, bases, placements, n_windows,
                                 batch_multiple, compute_modes))
            else:
                carried = placements[0].astype(np.int64)
                short = nc_full - n_windows
                break  # keep the partial dispatch buffered for more ROIs
        left = np.concatenate([carried, shelver.pending_order()])
        if len(left):
            cols = cols.take(left)
            # drop bases no leftover references (they were emitted) and
            # remap buf_idx — the buffer must not pin whole decode
            # payloads beyond their last pending ROI
            used, inv = np.unique(cols.bi, return_inverse=True)
            bases = [bases[int(u)] for u in used]
            cols.bi = inv.astype(np.int32)
            segs = [cols]
            buffered_bytes = int(cols.h.astype(np.int64) @ cols.w)
            buffered_n = len(left)
        else:
            segs = []
            bases = []
            buffered_bytes = 0
            buffered_n = 0
        # A carry-all pack means occupancy beat the 0.98 flush factor (the
        # whole buffer fit in < nc_full windows). Re-shelving the same
        # multi-thousand-item buffer per appended ROI is quadratic, so arm
        # the next flush only once the MISSING windows' worth of pixels has
        # actually arrived.
        next_flush = (flush_bytes if out
                      else buffered_bytes + max(short, 1) * win_bytes)
        return out

    for item in rois:
        if isinstance(item, pack.RoiBlock):
            append_block(item)
        else:
            smp, rid, img = item
            img = pack.pre_shrink(img, target_h, target_w)
            if img.shape[0] > WIN_H or img.shape[1] > WIN_W:
                img = pack.shrink_to_fit(img, WIN_H, WIN_W)
            pending_items.append((smp, rid, img))
            buffered_bytes += img.nbytes
            buffered_n += 1
        if buffered_bytes >= next_flush or buffered_n >= slot_cap:
            yield from flush(final=False)
    while buffered_n:
        yield from flush(final=True)


def shipped_bytes(batch: ShelfBatch) -> int:
    """Wire bytes of one dispatch (the windows tensor; slot metadata is
    ~24 B/ROI and rides alongside)."""
    return batch.windows.nbytes


def preprocess_mode(img: np.ndarray) -> int:
    """Mode pixel of one ROI from its own bytes while they are cache-hot
    (delegates to the single reference-border definition,
    :func:`sykepic_tpu_torch.ingest.pack.mode_pixel`)."""
    return pack.mode_pixel(img)
