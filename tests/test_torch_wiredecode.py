"""The port's wire decode (``sykepic_tpu_torch.ops.wiredecode``) against
the JAX package: bit-identical to ``wirecodec.decode_reference``, to the JAX
device decoder and to the encoder's input, with no tolerance (the codec is
lossless and every step is integer arithmetic)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from sykepic_tpu.ingest import ifcb as jifcb
from sykepic_tpu.ingest import shelf as jshelf
from sykepic_tpu.ingest import wirecodec as jwire
from sykepic_tpu.ops import wiredecode as jdecode
from sykepic_tpu_torch.ingest import wirecodec
from sykepic_tpu_torch.ops import wiredecode

FIXTURE = Path("tests/data/raw/valid/D20180712T065600_IFCB114")
H, W = jshelf.WIN_H, jshelf.WIN_W


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _smooth_windows(n=2, seed=7):
    """Camera-noise-like content with hard edges: thousands of exceptions,
    several scatter chunks."""
    rng = np.random.default_rng(seed)
    wins = (150 + rng.normal(0, 6, (n, H, W))).clip(0, 255).astype(np.uint8)
    for _ in range(40):
        y, x = rng.integers(0, H - 20), rng.integers(0, W - 20)
        wins[rng.integers(0, n), y:y + 20, x:x + 20] //= 3
    return wins


def _fixture_windows(n_windows=3, seed=0):
    """Shelf windows filled with real IFCB pixel content."""
    imgs = [img for _, img in jifcb.read_sample(FIXTURE).images()]
    rng = np.random.default_rng(seed)
    rois = []
    for i in range(400):
        src = imgs[i % len(imgs)]
        h = int(rng.integers(20, src.shape[0] + 1))
        w = int(rng.integers(20, src.shape[1] + 1))
        y = int(rng.integers(0, src.shape[0] - h + 1))
        x = int(rng.integers(0, src.shape[1] - w + 1))
        rois.append((0, i + 1, src[y:y + h, x:x + w]))
    batches = list(jshelf.pack_shelves(iter(rois), pre_shrink_to=(180, 180)))
    return np.concatenate([b.windows for b in batches])[:n_windows]


def _sparse_windows():
    """Gaps far beyond 255 exercise the dummy-advance entries."""
    wins = np.zeros((2, H, W), np.uint8)
    wins[0, 0, 0] = 200
    wins[1, H - 1, W - 1] = 131
    wins[1, 5, 7] = 99
    return wins


@pytest.mark.parametrize("make", [_smooth_windows, _fixture_windows,
                                  _sparse_windows])
def test_decode_bit_identical(make):
    windows = make()
    payload = jwire.encode(windows, force=True)
    ref = jwire.decode_reference(payload)
    np.testing.assert_array_equal(ref, windows)
    got = wiredecode.decode(payload, "cpu")
    assert got.dtype == torch.uint8 and got.shape == windows.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdecode.decode(payload)))


def test_smooth_content_spans_several_chunks():
    payload = jwire.encode(_smooth_windows(), force=True)
    assert len(payload.exc) > 2 * payload.chunk
    np.testing.assert_array_equal(
        wiredecode.decode(payload, "cpu").numpy(), _smooth_windows())


@pytest.mark.parametrize("make", [_smooth_windows, _fixture_windows])
def test_port_encoder_writes_the_jax_format(make):
    """The port's copy of the codec writes the same bytes."""
    windows = make()
    mine = wirecodec.encode(windows, force=True)
    theirs = jwire.encode(windows, force=True)
    for field in ("plane", "exc", "flags"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(theirs, field))
    assert (mine.shape, mine.n_exc, mine.chunk) == (
        theirs.shape, theirs.n_exc, theirs.chunk)
    np.testing.assert_array_equal(wirecodec.decode_reference(mine), windows)


def test_stages_match_jax():
    payload = jwire.encode(_smooth_windows(seed=11), force=True)
    d = wiredecode.unpack_plane(torch.from_numpy(payload.plane))
    jd = np.asarray(jdecode.unpack_plane(payload.plane))
    np.testing.assert_array_equal(d.numpy(), jd)
    d, carry = wiredecode.scatter_chunk(d, torch.from_numpy(payload.exc), -1)
    jcarry = np.int32(-1)
    for s in range(0, len(payload.exc), payload.chunk):
        jd, jcarry = jdecode.scatter_chunk(
            jd, payload.exc[s:s + payload.chunk], jcarry)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert int(carry) == int(jcarry)
    flags = torch.from_numpy(payload.flags)
    np.testing.assert_array_equal(
        wiredecode.finalize(d, flags).numpy(),
        np.asarray(jdecode.finalize(jd, payload.flags)))


def test_empty_exception_stream():
    base = (np.add.outer(np.arange(H), np.arange(W)) % 8).astype(np.uint8)
    payload = jwire.encode(base[None])
    assert len(payload.exc) == 0
    np.testing.assert_array_equal(
        wiredecode.decode(payload, "cpu").numpy()[0], base)
