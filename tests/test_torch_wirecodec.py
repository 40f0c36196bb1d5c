"""The port's wire codec (``sykepic_tpu_torch/ingest/wirecodec.py`` and its
native encoder) held to ``tests/test_wirecodec.py``: lossless round trips
through ``decode_reference`` and the port's decoder, noise falling back to
raw, ``chunk_for``, the predictor-axis choice, the native encoder equal to
the NumPy twin, lossless payload-pool recycling; and on every input the
port's ``encode`` equal to the JAX package's byte for byte. Tolerance:
exact equality.

Each case runs on the ``native`` side (the port's library required; a
failed build fails it) and, where the twin is a separate path, on the
``twin`` side (``native.lib`` patched to return None)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from sykepic_tpu.ingest import wirecodec as jwire
from sykepic_tpu_torch.ingest import ifcb, native, pack, shelf, wirecodec
from sykepic_tpu_torch.ops import wiredecode

FIXTURE = Path("tests/data/raw/valid/D20180712T065600_IFCB114")
H, W = shelf.WIN_H, shelf.WIN_W


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["native", "twin"])
def side(request, monkeypatch):
    if request.param == "native":
        assert native.lib() is not None, (
            "the port's native library did not build")
    else:
        monkeypatch.setattr(native, "lib", lambda: None)
    return request.param


def _windows_of(rois, n_windows):
    batches = list(shelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180)))
    wins = np.concatenate([b.windows for b in batches])[:n_windows]
    assert len(wins) == n_windows
    return np.ascontiguousarray(wins)


def _fixture_windows(n_windows=3, seed=0):
    """Shelf windows of real IFCB pixels cut at random (un-resized: the
    codec's worst realistic content)."""
    imgs = [img for _, img in ifcb.read_sample(FIXTURE).images()]
    rng = np.random.default_rng(seed)
    rois = []
    for i in range(400):
        src = imgs[i % len(imgs)]
        h = int(rng.integers(20, src.shape[0] + 1))
        w = int(rng.integers(20, src.shape[1] + 1))
        y = int(rng.integers(0, src.shape[0] - h + 1))
        x = int(rng.integers(0, src.shape[1] - w + 1))
        rois.append((0, i + 1, src[y:y + h, x:x + w]))
    return _windows_of(rois, n_windows)


def _resized_mix():
    """ROIs area-resized toward the network input, the stream the codec
    exists for (``pack.resize_area_u8`` is cv2's INTER_AREA)."""
    imgs = [img for _, img in ifcb.read_sample(FIXTURE).images()]
    rng = np.random.default_rng(3)
    rois = []
    for i in range(600):
        src = imgs[i % len(imgs)]
        h = min(int(rng.integers(40, 129)), src.shape[0])
        w = min(int(rng.integers(40, 129)), src.shape[1])
        rois.append((0, i + 1, pack.resize_area_u8(src, h, w)))
    return _windows_of(rois, 8)


def _flat_and_extreme():
    return np.stack([
        np.zeros((H, W), np.uint8), np.full((H, W), 255, np.uint8),
        np.tile((np.arange(W) % 256).astype(np.uint8), (H, 1)),
        np.tile((np.arange(H) % 256).astype(np.uint8)[:, None], (1, W))])


def _sparse():
    wins = np.zeros((2, H, W), np.uint8)
    wins[0, 0, 0] = 200
    wins[1, H - 1, W - 1] = 131
    wins[1, 5, 7] = 99
    wins[0, 3, 9] = 210
    return wins


def _no_exceptions():
    return (np.add.outer(np.arange(H), np.arange(W)) % 8).astype(np.uint8)[
        None]


def _smooth(seed):
    rng = np.random.default_rng([7, seed])
    wins = (int(rng.integers(100, 200)) + rng.normal(0, 4, (2, H, W))
            ).clip(0, 255).astype(np.uint8)
    for _ in range(30):  # hard edges, as organism silhouettes
        y, x = rng.integers(0, H - 20), rng.integers(0, W - 20)
        wins[rng.integers(0, 2), y:y + 20, x:x + 20] //= 3
    return wins


def _stripes():
    return np.stack([
        np.tile((np.arange(H) % 2 * 200).astype(np.uint8)[:, None], (1, W)),
        np.tile((np.arange(W) % 2 * 200).astype(np.uint8), (H, 1))])


# name -> (windows, force): force skips the payoff gate
CASES = {
    "fixture": (lambda: _fixture_windows(6), True),
    "resized_mix": (_resized_mix, False),
    "flat_and_extreme": (_flat_and_extreme, True),
    "sparse_far_exceptions": (_sparse, True),
    "no_exceptions": (_no_exceptions, False),
    "stripes": (_stripes, True),
    **{f"smooth_{s}": (lambda s=s: _smooth(s), True) for s in range(5)},
}


def _jax_encode(windows, force=False):
    """The JAX package's encoder on its NumPy path, the codec's contract
    (its native encoder escapes some wrapping deltas the contract does not:
    ROADMAP Queue 3), so the case does not depend on which library the JAX
    package loaded."""
    old, jwire.USE_NATIVE = jwire.USE_NATIVE, False
    try:
        return jwire.encode(windows, force=force)
    finally:
        jwire.USE_NATIVE = old


def _same_payload(mine, theirs):
    for field in ("plane", "exc", "flags"):
        a, b = getattr(mine, field), getattr(theirs, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (mine.shape, mine.n_exc, mine.chunk) == (
        theirs.shape, theirs.n_exc, theirs.chunk)


@pytest.mark.parametrize("name", sorted(CASES))
def test_roundtrip_and_bytes_equal_jax(side, name):
    make, force = CASES[name]
    windows = make()
    payload = wirecodec.encode(windows, force=force)
    assert payload is not None, "encode fell back to raw"
    if not force:
        assert payload.nbytes < windows.nbytes
    _same_payload(payload, _jax_encode(windows, force=force))
    np.testing.assert_array_equal(wirecodec.decode_reference(payload),
                                  windows)
    np.testing.assert_array_equal(
        wiredecode.decode(payload, "cpu").numpy(), windows)


def test_payoff_on_resized_mix():
    wins = _resized_mix()
    assert wirecodec.encode(wins).nbytes < 0.78 * wins.nbytes


def test_no_exceptions_ship_no_chunks():
    payload = wirecodec.encode(_no_exceptions())
    assert payload.n_exc == 0 and len(payload.exc) == 0


def test_predictor_flags_choose_cheaper_axis(side):
    payload = wirecodec.encode(_stripes(), force=True)
    assert payload.flags.tolist() == [1, 0]  # horizontal, then vertical
    assert payload.n_exc <= 2 * H  # only the absolute first row/col escapes


def test_noise_falls_back_to_raw(side):
    wins = np.random.default_rng(1).integers(0, 256, (2, H, W), np.uint8)
    assert wirecodec.encode(wins) is None
    assert _jax_encode(wins) is None


def test_chunk_padding_is_exact_multiple(side):
    payload = wirecodec.encode(_fixture_windows())
    assert payload.chunk == wirecodec.chunk_for(3 * H * W)
    assert len(payload.exc) % payload.chunk == 0


def test_chunk_scales_with_dispatch_size():
    assert wirecodec.chunk_for(64 * 192 * 512) == wirecodec.CHUNK
    assert wirecodec.chunk_for(64 * 32 * 64) == wirecodec.MIN_CHUNK
    prev = 0
    for npx in (1, 10_000, 100_000, 1_000_000, 10_000_000, 10**9):
        c = wirecodec.chunk_for(npx)
        assert c >= prev and (c & (c - 1)) == 0
        assert c == jwire.chunk_for(npx)
        prev = c


@pytest.mark.parametrize("name", ["fixture", "flat_and_extreme",
                                  "sparse_far_exceptions", "smooth_0"])
def test_native_encoder_matches_numpy_bytes(monkeypatch, name):
    assert native.lib() is not None, "the port's native library did not build"
    windows = CASES[name][0]()
    nat = wirecodec.encode(windows, force=True)
    monkeypatch.setattr(wirecodec, "USE_NATIVE", False)
    _same_payload(nat, wirecodec.encode(windows, force=True))


def test_payload_pool_recycling_is_lossless(monkeypatch):
    """encode -> recycle -> encode other content reuses the native
    encoder's buffers with no cross-contamination (the twin allocates
    afresh, as the JAX package's does)."""
    assert native.lib() is not None, "the port's native library did not build"
    monkeypatch.setattr(wirecodec, "_POOL", type(wirecodec._POOL)(
        wirecodec._POOL.default_factory))
    rng = np.random.default_rng(5)
    smooth = (rng.integers(0, 3, (4, H, W), np.int16).cumsum(axis=2)
              % 256).astype(np.uint8)
    p1 = wirecodec.encode(smooth, force=True)
    np.testing.assert_array_equal(wirecodec.decode_reference(p1), smooth)
    buf_ids = {id(p1.plane), id(p1.exc)}
    wirecodec.recycle_payload(p1)
    other = (rng.integers(0, 3, (4, H, W), np.int16).cumsum(axis=1)
             % 256).astype(np.uint8)
    p2 = wirecodec.encode(other, force=True)
    assert {id(p2.plane), id(p2.exc)} & buf_ids, "pool was never used"
    np.testing.assert_array_equal(wirecodec.decode_reference(p2), other)
    _same_payload(p2, _jax_encode(other, force=True))
