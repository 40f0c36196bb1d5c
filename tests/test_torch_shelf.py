"""The port's shelf packer (``sykepic_tpu_torch/ingest/shelf.py``, with its
native placement and blits in ``ingest/native``) held to the behaviours of
``tests/test_shelf.py`` and, on the same seeded streams, equal to the JAX
package's packer field by field. Tolerance: exact equality everywhere.

Native against twin: each native case requires the port's library (a failed
build fails it); each twin run patches ``native.lib`` to return None. The
JAX side may run on its own library or its NumPy twin; only outputs are
compared."""

import numpy as np
import pytest
import torch

from sykepic_tpu.ingest import pack as jpack
from sykepic_tpu.ingest import shelf as jshelf
from sykepic_tpu_torch.ingest import native, pack, shelf

FIELDS = ("win_idx", "y0", "x0", "heights", "widths", "roi_ids",
          "sample_idx", "modes")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _require_native():
    assert native.lib() is not None, "the port's native library did not build"


def _rand_rois(n, rng, h_range=(8, 180), w_range=(8, 180)):
    out = []
    for i in range(n):
        h = int(rng.integers(*h_range))
        w = int(rng.integers(*w_range))
        out.append((i % 7, i + 1, rng.integers(0, 255, (h, w), np.uint8)))
    return out


def _rois_to_block(rois, sample_idx=0, pack_mod=pack):
    """Per-ROI tuples as one columnar RoiBlock over a single flat base."""
    hs = np.array([im.shape[0] for _, _, im in rois], np.int64)
    ws = np.array([im.shape[1] for _, _, im in rois], np.int64)
    offs = np.zeros(len(rois), np.int64)
    np.cumsum((hs * ws)[:-1], out=offs[1:])
    return pack_mod.RoiBlock(
        sample_idx=sample_idx,
        roi_ids=np.array([rid for _, rid, _ in rois], np.int64),
        heights=hs, widths=ws, offsets=offs,
        base=np.concatenate([im.reshape(-1) for _, _, im in rois]))


def _blocks(rois, pack_mod):
    per_sample = {}
    for t in rois:
        per_sample.setdefault(t[0], []).append(t)
    return [_rois_to_block(v, smp, pack_mod) for smp, v in per_sample.items()]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.n_valid == b.n_valid
        np.testing.assert_array_equal(a.windows, b.windows)
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)


# -- the port against the JAX package ----------------------------------------

STREAMS = {
    "tuples_400_modes": dict(n=400, seed=1, kw=dict(compute_modes=True)),
    "blocks_oversized": dict(n=300, seed=2, blocks=True, h=(4, 320),
                             w=(4, 700), kw=dict(compute_modes=True)),
    "slot_cap_1500": dict(n=4000, seed=11, h=(8, 12), w=(8, 12),
                          kw=dict(slot_cap=1500)),
    "multiple_6": dict(n=3000, seed=12, h=(8, 10), w=(8, 10),
                       kw=dict(batch_multiple=6, slot_cap=shelf.SLOT_CAP)),
    "nc_full_50": dict(n=3000, seed=13, h=(24, 64), w=(40, 128),
                       blocks=True, kw=dict(nc_full=50)),
    "multiple_3_modes": dict(n=700, seed=24, h=(4, 120), w=(4, 180),
                             kw=dict(batch_multiple=3, compute_modes=True)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_batches_equal_jax(name):
    s = STREAMS[name]
    rois = _rand_rois(s["n"], np.random.default_rng(s["seed"]),
                      s.get("h", (8, 180)), s.get("w", (8, 180)))
    if s.get("blocks"):
        ours, theirs = _blocks(rois, pack), _blocks(rois, jpack)
    else:
        ours, theirs = rois, rois
    got = list(shelf.pack_shelves(iter(ours), pre_shrink_to=(180, 180),
                                  **s["kw"]))
    want = list(jshelf.pack_shelves(iter(theirs), pre_shrink_to=(180, 180),
                                    **s["kw"]))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("multiple", [1, 3, 6, 8])
def test_ladders_equal_jax(multiple):
    def outcome(fn, *args):
        try:
            return fn(*args)
        except ValueError as e:  # a cap below the smallest dispatch
            return str(e)

    for n in range(0, 5000, 7):
        assert shelf.pad_slots(n, multiple) == jshelf.pad_slots(n, multiple)
        assert (outcome(shelf.floor_slots, n + 1, multiple)
                == outcome(jshelf.floor_slots, n + 1, multiple))
    for n in range(0, 80):
        assert shelf.pad_nc(n) == jshelf.pad_nc(n)
    assert shelf.NC_LADDER == jshelf.NC_LADDER
    assert (shelf.WIN_H, shelf.WIN_W, shelf.SLOT_CAP) == (
        jshelf.WIN_H, jshelf.WIN_W, jshelf.SLOT_CAP)


# -- the behaviours of tests/test_shelf.py -----------------------------------

@pytest.mark.parametrize("n", [1, 5, 37, 400])
def test_every_roi_placed_exactly_once_and_lossless(n):
    rois = _rand_rois(n, np.random.default_rng(n))
    seen = {}
    for b in shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                                compute_modes=True):
        assert b.windows.shape[1:] == (shelf.WIN_H, shelf.WIN_W)
        assert b.windows.shape[0] in shelf.NC_LADDER
        for s in range(b.n_valid):
            key = (int(b.sample_idx[s]), int(b.roi_ids[s]))
            assert key not in seen, f"duplicate {key}"
            h, w = int(b.heights[s]), int(b.widths[s])
            y, x = int(b.y0[s]), int(b.x0[s])
            assert 0 <= y and y + h <= shelf.WIN_H
            assert 0 <= x and x + w <= shelf.WIN_W
            seen[key] = b.windows[int(b.win_idx[s]), y:y + h, x:x + w].copy()
    expect = {(smp, rid): img for smp, rid, img in rois}
    assert set(seen) == set(expect)
    for key, img in expect.items():
        np.testing.assert_array_equal(seen[key], img, err_msg=str(key))


def test_no_overlap_between_rois():
    rois = _rand_rois(300, np.random.default_rng(3))
    for b in shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180)):
        cover = np.zeros(b.windows.shape, np.int32)
        for s in range(b.n_valid):
            w_, y, x = int(b.win_idx[s]), int(b.y0[s]), int(b.x0[s])
            cover[w_, y:y + int(b.heights[s]), x:x + int(b.widths[s])] += 1
        assert cover.max() <= 1


def test_oversized_rois_are_shrunk_as_jax():
    big = np.random.default_rng(4).integers(0, 255, (700, 900), np.uint8)
    (b,) = list(shelf.pack_shelves(iter([(0, 1, big)]),
                                   pre_shrink_to=(180, 180)))
    (jb,) = list(jshelf.pack_shelves(iter([(0, 1, big)]),
                                     pre_shrink_to=(180, 180)))
    assert b.n_valid == 1
    assert int(b.heights[0]) <= shelf.WIN_H
    assert int(b.widths[0]) <= shelf.WIN_W
    _assert_batches_equal([b], [jb])


@pytest.mark.parametrize("mult", [1, 3, 8])
def test_slot_padding_respects_batch_multiple(mult):
    rois = _rand_rois(10, np.random.default_rng(5))
    for b in shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                                batch_multiple=mult):
        assert len(b.win_idx) % mult == 0
        assert len(b.win_idx) >= b.n_valid


def test_nc_full_beyond_ladder_rejected():
    rois = _rand_rois(4, np.random.default_rng(1))
    gen = shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                             nc_full=shelf.NC_LADDER[-1] * 2)
    with pytest.raises(ValueError, match="window-count ladder"):
        next(gen)


def test_off_ladder_slot_cap_never_overshoots():
    rois = _rand_rois(4000, np.random.default_rng(11), (8, 12), (8, 12))
    sizes = set()
    for b in shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                                slot_cap=1500):
        assert len(b.win_idx) <= 1500
        sizes.add(len(b.win_idx))
    assert max(sizes) == shelf.floor_slots(1500)


def test_slot_cap_holds_with_non_pow2_multiple():
    rois = _rand_rois(9000, np.random.default_rng(12), (8, 10), (8, 10))
    for b in shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                                batch_multiple=6, slot_cap=shelf.SLOT_CAP):
        assert len(b.win_idx) <= shelf.SLOT_CAP
        assert len(b.win_idx) % 6 == 0


def test_off_ladder_nc_full_snaps_down():
    rois = _rand_rois(6000, np.random.default_rng(13), (24, 64), (40, 128))
    ncs = [b.windows.shape[0] for b in shelf.pack_shelves(
        iter(rois), pre_shrink_to=(180, 180), nc_full=50)]
    assert 48 in ncs and 56 not in ncs, ncs


def test_carry_does_not_rethrash_the_buffer(monkeypatch):
    rng = np.random.default_rng(14)
    rois = [(0, i + 1, rng.integers(0, 255, (32, 64), np.uint8))
            for i in range(12_000)]
    n_packs = 0
    orig = shelf._Shelver.__init__

    def counting(self, heights, widths):
        nonlocal n_packs
        n_packs += 1
        orig(self, heights, widths)

    monkeypatch.setattr(shelf._Shelver, "__init__", counting)
    batches = list(shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180)))
    assert sum(b.n_valid for b in batches) == 12_000
    assert n_packs <= len(batches) * 3 + 4, (n_packs, len(batches))


# -- native against its twin -------------------------------------------------

def _pack_sets():
    rng = np.random.default_rng(21)
    sets = [
        (np.full(400, 24), rng.integers(4, 181, 400)),
        (rng.integers(4, 181, 120), np.full(120, shelf.WIN_W)),
        (np.full(3000, 1), np.full(3000, 1)),
        (np.full(50, shelf.WIN_H), rng.integers(4, 181, 50)),
        (np.array([shelf.WIN_H + 8, 40]), np.array([50, 60])),  # over-tall
    ]
    for _ in range(5):
        n = int(rng.integers(50, 3000))
        h, w = rng.integers(4, 181, n), rng.integers(4, 181, n)
        if n > 100:
            h[::3], w[::5] = 24, 40  # duplicate sizes: the stable tie-break
        sets.append((h, w))
    caps = [(int(rng.choice([1, 3, 8, 64])), int(rng.choice([32, 500, 4096])))
            for _ in sets]
    return [(h.astype(np.int64), w.astype(np.int64), *c)
            for (h, w), c in zip(sets, caps)]


@pytest.mark.parametrize("case", range(10))
def test_native_pack_matches_python_twin(case):
    _require_native()
    h, w, max_windows, max_slots = _pack_sets()[case]
    nat = shelf._Shelver(h, w)
    assert nat._native is not None
    py = shelf._Shelver(h, w)
    py._native = None
    while True:
        p_nat, w_nat = nat.pack(max_windows, max_slots)
        p_py, w_py = py.pack(max_windows, max_slots)
        assert w_nat == w_py
        for a, b in zip(p_nat, p_py):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(nat.pending_order(), py.pending_order())
        if len(p_nat[0]) == 0:
            break


def test_native_pack_keeps_an_overtall_item_pending():
    _require_native()
    h, w = np.array([shelf.WIN_H + 8, 40]), np.array([50, 60])
    nat, py = shelf._Shelver(h, w), shelf._Shelver(h, w)
    py._native = None
    (p_nat, w_nat), (p_py, w_py) = nat.pack(8, 4096), py.pack(8, 4096)
    assert w_nat == w_py
    for a, b in zip(p_nat, p_py):
        np.testing.assert_array_equal(a, b)
    assert nat.pending() and py.pending()


def test_native_blit_rejects_out_of_range_window():
    _require_native()
    windows = np.zeros((1, shelf.WIN_H, shelf.WIN_W), np.uint8)
    img = np.ones((4, 4), np.uint8)
    assert native.shelf_blit(
        [img], np.array([4], np.int32), np.array([4], np.int32),
        np.array([5], np.int32), np.array([0], np.int32),
        np.array([0], np.int32), windows) is None
    assert not windows.any()


def test_native_blit_matches_slice_assignment():
    _require_native()
    rng = np.random.default_rng(22)
    imgs = [rng.integers(0, 256, (int(h), int(w)), np.uint8)
            for h, w in rng.integers(1, 60, (30, 2))]
    hs = np.array([i.shape[0] for i in imgs], np.int32)
    ws = np.array([i.shape[1] for i in imgs], np.int32)
    win = rng.integers(0, 3, 30).astype(np.int32)
    y0 = rng.integers(0, shelf.WIN_H - 60, 30).astype(np.int32)
    x0 = rng.integers(0, shelf.WIN_W - 60, 30).astype(np.int32)
    got = np.zeros((3, shelf.WIN_H, shelf.WIN_W), np.uint8)
    assert native.shelf_blit(imgs, hs, ws, win, y0, x0, got) is True
    want = np.zeros_like(got)
    for im, w_, y, x in zip(imgs, win, y0, x0):
        want[w_, y:y + im.shape[0], x:x + im.shape[1]] = im
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("blocks", [False, True])
def test_native_and_twin_dispatches_identical(monkeypatch, blocks):
    _require_native()
    rois = _rand_rois(700, np.random.default_rng(24), (4, 120), (4, 180))

    def run():
        stream = _blocks(rois, pack) if blocks else rois
        return list(shelf.pack_shelves(iter(stream), pre_shrink_to=(180, 180),
                                       compute_modes=True))

    fast = run()
    monkeypatch.setattr(native, "lib", lambda: None)
    slow = run()
    _assert_batches_equal(fast, slow)


def test_native_mode_matches_numpy_contract():
    _require_native()
    rng = np.random.default_rng(23)
    cases = [rng.integers(0, 256, (int(rng.integers(1, 150)),
                                   int(rng.integers(1, 150)))).astype(np.uint8)
             for _ in range(40)]
    cases.append(np.full((5, 5), 200, np.uint8))
    cases.append((rng.integers(0, 4, (60, 60)) * 3).astype(np.uint8))  # ties
    for img in cases:
        want = int(np.bincount(img.ravel(), minlength=256).argmax())
        assert native.u8_mode(img) == want
        assert pack.mode_pixel(img) == want == jpack.mode_pixel(img)


# -- pools, blocks --------------------------------------------------------------

def test_window_pool_recycling_is_lossless(monkeypatch):
    monkeypatch.setattr(shelf, "_WINDOW_POOL", type(shelf._WINDOW_POOL)(
        shelf._WINDOW_POOL.default_factory))
    rois = _rand_rois(300, np.random.default_rng(77), (4, 120), (4, 180))
    clean = list(shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                                    compute_modes=True))
    dirty_ids, snapshots = set(), []
    for b in clean:
        dirty_ids.add(id(b.windows))
        snapshots.append(b.windows.copy())
        shelf.recycle_windows(b)
        assert b.windows is None
    again = list(shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                                    compute_modes=True))
    assert any(id(b.windows) in dirty_ids for b in again), "pool never used"
    assert len(again) == len(clean)
    for snap, a, b in zip(snapshots, clean, again):
        np.testing.assert_array_equal(snap, b.windows)
        np.testing.assert_array_equal(a.win_idx, b.win_idx)
        np.testing.assert_array_equal(a.roi_ids, b.roi_ids)


def test_recycle_windows_ignores_foreign_shapes(monkeypatch):
    monkeypatch.setattr(shelf, "_WINDOW_POOL", type(shelf._WINDOW_POOL)(
        shelf._WINDOW_POOL.default_factory))
    one = np.zeros(1, np.int32)
    b = shelf.ShelfBatch(
        windows=np.zeros((2, 64, 64), np.uint8), win_idx=one, y0=one, x0=one,
        heights=np.ones(1, np.int32), widths=np.ones(1, np.int32),
        roi_ids=np.zeros(1, np.int64), sample_idx=one, n_valid=1)
    shelf.recycle_windows(b)
    assert not any(shelf._WINDOW_POOL.values())


def test_block_stream_matches_tuple_stream():
    rois = _rand_rois(80, np.random.default_rng(11), (4, 320), (4, 700))
    blocks = _blocks(rois, pack)
    tuples = [t for blk in blocks for t in blk.items()]
    a = list(shelf.pack_shelves(iter(blocks), pre_shrink_to=(180, 180),
                                compute_modes=True))
    b = list(shelf.pack_shelves(iter(tuples), pre_shrink_to=(180, 180),
                                compute_modes=True))
    _assert_batches_equal(a, b)


def test_block_stream_content_lossless_across_flushes():
    rois = _rand_rois(3000, np.random.default_rng(12), (4, 260), (4, 400))
    seen = {}
    for b in shelf.pack_shelves(iter(_blocks(rois, pack)),
                                pre_shrink_to=(180, 180)):
        for s in range(b.n_valid):
            key = (int(b.sample_idx[s]), int(b.roi_ids[s]))
            assert key not in seen
            h, w = int(b.heights[s]), int(b.widths[s])
            y, x = int(b.y0[s]), int(b.x0[s])
            seen[key] = b.windows[int(b.win_idx[s]), y:y + h, x:x + w].copy()
    assert len(seen) == len(rois)
    for smp, rid, img in rois:
        np.testing.assert_array_equal(seen[(smp, rid)],
                                      pack.pre_shrink(img, 180, 180))


def test_block_with_bad_geometry_raises():
    blk = pack.RoiBlock(
        sample_idx=0, roi_ids=np.array([1], np.int64),
        heights=np.array([64], np.int64), widths=np.array([64], np.int64),
        offsets=np.array([100], np.int64), base=np.zeros(64 * 64, np.uint8))
    with pytest.raises(ValueError, match="outside its pixel buffer"):
        list(shelf.pack_shelves(iter([blk]), pre_shrink_to=(180, 180)))


def test_roi_block_items_roundtrip():
    rois = _rand_rois(50, np.random.default_rng(17))
    blk = _rois_to_block(rois, sample_idx=3)
    out = list(pack.roi_items(iter([blk, (9, 99, rois[0][2])])))
    assert len(out) == 51
    for (smp, rid, img), (_, orig_rid, orig_img) in zip(out[:50], rois):
        assert smp == 3 and rid == orig_rid
        np.testing.assert_array_equal(img, orig_img)
    assert out[50][:2] == (9, 99)


# -- the engine's slot cap, shared with the JAX engine -----------------------

def test_slot_cap_bounds_dispatch(model_dir):
    from sykepic_tpu_torch.compute import probability

    clf = probability.prepare_model(model_dir, batch_size=2048, device="cpu")
    assert clf._shelf_slot_cap == 2048
    rois = _rand_rois(3000, np.random.default_rng(5), (8, 12), (8, 12))
    for b in shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180),
                                slot_cap=clf._shelf_slot_cap):
        assert len(b.win_idx) <= 2048


@pytest.mark.parametrize("key,multiple", [((3, 100), 1), ((1, None), 6)])
def test_precompile_snaps_and_clamps_shelf_keys(model_dir, key, multiple):
    """precompile warms the ladder shape pack_shelves emits: an off-ladder
    (windows, slots) pair snaps up, and a slot count near the cap clamps
    to the floored cap (here under a 6-way batch multiple)."""
    from sykepic_tpu_torch.compute import probability

    clf = probability.prepare_model(model_dir, batch_size=64, device="cpu")
    clf._batch_multiple = multiple
    slots = clf._shelf_slot_cap - 10 if key[1] is None else key[1]
    seen = []

    def spy(batch, meta=None):
        seen.append((batch.windows.shape[0], len(batch.win_idx)))
        return torch.zeros(len(batch.win_idx), 1)

    clf.dispatch_shelf = spy
    clf.precompile([(key[0], slots)])
    want = (shelf.pad_nc(key[0]),
            min(shelf.pad_slots(slots, multiple),
                shelf.floor_slots(clf._shelf_slot_cap, multiple)))
    assert seen == [want]
    assert want == (jshelf.pad_nc(key[0]),
                    min(jshelf.pad_slots(slots, multiple),
                        jshelf.floor_slots(clf._shelf_slot_cap, multiple)))
