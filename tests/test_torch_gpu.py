"""Kernels on the card against their plain versions (K1,
``csrc/resize_pad.cu``; K2, ``csrc/flood.cu``). These need a CUDA card: a
CUDA kernel has no CPU mode, so here they skip. The file imports neither JAX
nor the repo's ``conftest.py`` fixtures, so it also runs on a machine
without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: K1 in float32 within 1e-3/255 of the plain version (the kernel
repeats its float steps one by one, so in practice they agree exactly), in
bfloat16 within one bf16 ulp of the plain version cast to bf16; K2 exact
(bool masks, and the same step count per image), in each of its three forms.
"""

import numpy as np
import pytest
import torch

from sykepic_tpu_torch.ops import flood, preprocess, resize_pad

ATOL = 1e-3 / 255


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _slots(rng, b=32, ch=64, cw=128):
    hs = rng.integers(1, ch + 1, b)
    ws = rng.integers(1, cw + 1, b)
    canvas = rng.integers(0, 256, (b, ch, cw), dtype=np.uint8)
    geom = preprocess.compute_geometry(hs, ws, 180, 180)
    border = rng.integers(0, 256, b)
    return canvas, preprocess.slot_meta(hs, ws, *geom, border)


def _shelf(rng, nc=4, r=300):
    wins = rng.integers(0, 256, (nc, 192, 512), dtype=np.uint8)
    hs = rng.integers(1, 181, r)
    ws = rng.integers(1, 181, r)
    y0 = (rng.random(r) * (192 - hs)).astype(np.int32)
    x0 = (rng.random(r) * (512 - ws)).astype(np.int32)
    geom = preprocess.compute_geometry(hs, ws, 180, 180)
    border = rng.integers(0, 256, r)
    return wins, preprocess.slot_meta(hs, ws, *geom, border,
                                      rng.integers(0, nc, r), y0, x0)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_slots, _shelf])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, make, dtype):
    pixels, meta = make(np.random.default_rng(0))
    pix = torch.from_numpy(pixels).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    before = resize_pad.launches
    out = resize_pad.resize_pad(pix, m, 180, 180, 3, dtype)
    torch.cuda.synchronize()
    assert resize_pad.launches == before + 1
    assert out.shape == (meta.shape[1], 180, 180, 3) and out.dtype == dtype
    plain = preprocess.resize_pad_plain(torch.from_numpy(pixels),
                                        torch.from_numpy(meta), 180, 180, 3)
    err = (out.cpu().float() - plain.to(dtype).float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= ATOL
    else:
        assert bool((err <= plain.to(dtype).float().abs() * 2.0 ** -7).all())


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    pixels, meta = _slots(np.random.default_rng(1), b=2)
    pix = torch.from_numpy(pixels).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    with pytest.raises(ValueError):
        resize_pad.resize_pad(pix.float(), m, 180, 180)
    with pytest.raises(ValueError):
        resize_pad.resize_pad(pix, m.long(), 180, 180)
    with pytest.raises(ValueError):
        resize_pad.resize_pad(pix, m.cpu(), 180, 180)
    with pytest.raises(ValueError):
        resize_pad.resize_pad(pix, m, 180, 180, dtype=torch.float16)
    with pytest.raises(ValueError):
        resize_pad.resize_pad(pix[:, :, ::2], m, 180, 180)


@pytest.mark.gpu
def test_empty_dispatch(cuda):
    pix = torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda)
    m = torch.zeros((len(preprocess.META_ROWS), 0), dtype=torch.int32,
                    device=cuda)
    assert resize_pad.resize_pad(pix, m, 180, 180).shape == (0, 180, 180, 3)


def _flood_random(rng, b, h, w, p=0.5):
    within = rng.uniform(size=(b, h, w)) < p
    seed = np.zeros_like(within)
    seed[:, 0, :] = within[:, 0, :]  # border seeds, as fill_holes makes
    seed[:, :, -1] = within[:, :, -1]
    return seed, within


def _flood_ring(rng, b, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    free = np.broadcast_to(~((r < 0.4 * min(h, w)) & (r > 0.2 * min(h, w))),
                           (b, h, w)).copy()
    seed = np.zeros_like(free)
    seed[:, 0, :] = seed[:, -1, :] = seed[:, :, 0] = seed[:, :, -1] = True
    return seed & free, free


def _flood_empty_seed(rng, b, h, w):
    return np.zeros((b, h, w), bool), rng.uniform(size=(b, h, w)) < 0.7


def _flood_full(rng, b, h, w):
    seed = np.zeros((b, h, w), bool)
    seed[np.arange(b), rng.integers(0, h, b), rng.integers(0, w, b)] = True
    return seed, np.ones((b, h, w), bool)


def _flood_serpentine(rng, b, h, w):
    # a 1-pixel corridor: every other row open, joined at alternate ends,
    # seeded at one end; the longest chain a canvas holds (~h w / 2 steps)
    within = np.zeros((h, w), bool)
    within[::2] = True
    within[1::4, -1] = True
    within[3::4, 0] = True
    seed = np.zeros((h, w), bool)
    seed[0, 0] = True
    return (np.broadcast_to(seed, (b, h, w)).copy(),
            np.broadcast_to(within, (b, h, w)).copy())


_FLOOD_INPUTS = {"random": _flood_random, "ring": _flood_ring,
                 "empty_seed": _flood_empty_seed, "full": _flood_full,
                 "serpentine": _flood_serpentine}
_COUNTERS = {"warp": "warp_launches", "shared": "launches",
             "global": "global_launches"}


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["warp", "shared", "global"])
@pytest.mark.parametrize("case", [
    ("random", 64, 48, 96, None), ("random", 3, 28, 33, None),
    ("random", 2, 200, 700, None), ("ring", 2, 40, 40, None),
    ("random", 16, 48, 96, 1), ("random", 16, 48, 96, 2),
    ("random", 16, 48, 96, 5), ("ring", 1, 64, 64, 0),
    # the warp form's (rows, words) corners, at batches that are not a
    # multiple of its 8 images a block
    ("random", 9, 32, 32, None), ("random", 9, 33, 33, None),
    ("random", 5, 64, 64, None), ("random", 3, 128, 256, None),
    ("random", 11, 96, 200, None),
    ("random", 9, 40, 61, None),  # a width that is not a multiple of 8
    ("random", 16, 48, 96, 0),
    ("empty_seed", 4, 48, 96, None), ("full", 4, 48, 96, None),
    ("serpentine", 2, 64, 64, None), ("serpentine", 1, 128, 256, None),
    # the shared-memory form's 4, 16 and 32 words a thread (the largest
    # canvas of the fused workload, and slot canvases up to 1024x896)
    ("random", 3, 256, 512, None), ("random", 1, 1024, 512, None),
    ("random", 1, 1024, 896, None)])
def test_flood_kernel_matches_plain_version(cuda, form, case):
    kind, b, h, w, cap = case
    seed, within = _FLOOD_INPUTS[kind](np.random.default_rng(b * h + w), b,
                                       h, w)
    s = torch.from_numpy(seed).to(cuda)
    m = torch.from_numpy(within).to(cuda)
    cap = h * w if cap is None else cap
    if form == "warp" and (h > 128 or w > 256):
        with pytest.raises(ValueError):
            flood.flood(s, m, cap, form=form)
        return
    counter = _COUNTERS[form]
    before = getattr(flood, counter)
    out, steps = flood.flood(s, m, cap, return_steps=True, form=form)
    torch.cuda.synchronize()
    assert getattr(flood, counter) > before
    # the plain version on the card past 512k pixels (hundreds of steps)
    where = cuda if h * w >= 1 << 19 else torch.device("cpu")
    want, want_steps = flood.flood_plain(s.to(where), m.to(where), cap,
                                         return_steps=True)
    assert out.dtype == torch.bool and out.shape == (b, h, w)
    assert torch.equal(out.to(where), want)
    assert torch.equal(steps.to(where), want_steps)
    # without the step counts the same mask
    assert torch.equal(flood.flood(s, m, cap, form=form).to(where), want)


@pytest.mark.gpu
def test_flood_picks_the_global_form_past_shared_memory(cuda):
    seed, within = _flood_random(np.random.default_rng(5), 2, 1024, 1400,
                                 p=0.6)
    assert flood.shared_bytes(1024, 1400) > flood.smem_limit(cuda)
    s = torch.from_numpy(seed).to(cuda)
    m = torch.from_numpy(within).to(cuda)
    before = (flood.launches, flood.warp_launches, flood.global_launches)
    out = flood.flood(s, m, 1024 * 1400)
    torch.cuda.synchronize()
    assert (flood.launches, flood.warp_launches) == before[:2]
    assert flood.global_launches > before[2]
    # the plain version on the card too: 1024x1400 takes thousands of steps
    assert torch.equal(out, flood.flood_plain(s, m, 1024 * 1400))
    with pytest.raises(ValueError):
        flood.flood(s, m, 10, form="shared")
    with pytest.raises(ValueError):
        flood.flood(s, m, 10, form="warp")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,picked", [((8, 200, 300), "shared"),
                                          ((8, 48, 96), ("warp", 2, 4))])
def test_flood_one_launch_per_call_in_shared_memory(cuda, shape, picked):
    # one launch per call in each one-launch form, picked by size; the
    # warp case holds the warp_launches count
    seed, within = _flood_random(np.random.default_rng(6), *shape)
    s = torch.from_numpy(seed).to(cuda)
    m = torch.from_numpy(within).to(cuda)
    assert flood.pick_form(*shape[1:], flood.smem_limit(cuda)) == picked
    mine = _COUNTERS["shared" if picked == "shared" else "warp"]
    before = {c: getattr(flood, c) for c in _COUNTERS.values()}
    for k in range(3):
        flood.flood(s, m, shape[1] * shape[2])
        assert getattr(flood, mine) == before[mine] + k + 1
    for c in _COUNTERS.values():
        if c != mine:
            assert getattr(flood, c) == before[c]


@pytest.mark.gpu
def test_flood_rejects_what_it_does_not_take(cuda):
    seed, within = _flood_random(np.random.default_rng(7), 2, 16, 16)
    s = torch.from_numpy(seed).to(cuda)
    m = torch.from_numpy(within).to(cuda)
    for bad in ((s.to(torch.uint8), m), (s, m.float()), (s, m.cpu()),
                (s[:, :, ::2], m[:, :, ::2]), (s[:, :8], m),
                (s[0], m[0])):
        with pytest.raises(ValueError):
            flood.flood(*bad, 10)
    with pytest.raises(ValueError):
        flood.flood(s, m, -1)
    with pytest.raises(ValueError):
        flood.flood(s, m, 10, form="tiles")


@pytest.mark.gpu
def test_flood_empty_batch(cuda):
    empty = torch.zeros((0, 48, 96), dtype=torch.bool, device=cuda)
    before = (flood.launches, flood.warp_launches, flood.global_launches)
    out, steps = flood.flood(empty, empty, 100, return_steps=True)
    assert out.shape == (0, 48, 96) and steps.shape == (0,)
    assert (flood.launches, flood.warp_launches,
            flood.global_launches) == before
