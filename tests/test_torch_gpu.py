"""Kernels on the card against their plain versions (K1,
``csrc/resize_pad.cu``; K2, ``csrc/flood.cu``). These need a CUDA card: a
CUDA kernel has no CPU mode, so here they skip. The file imports neither JAX
nor the repo's ``conftest.py`` fixtures, so it also runs on a machine
without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: K1 in float32 within 1e-3/255 of the plain version (the kernel
repeats its float steps one by one, so in practice they agree exactly), in
bfloat16 within one bf16 ulp of the plain version cast to bf16; K2 exact
(bool masks, and the same step count per image), in both of its forms.
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


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["shared", "global"])
@pytest.mark.parametrize("case", [
    ("random", 64, 48, 96, None), ("random", 3, 28, 33, None),
    ("random", 2, 200, 700, None), ("ring", 2, 40, 40, None),
    ("random", 16, 48, 96, 1), ("random", 16, 48, 96, 2),
    ("random", 16, 48, 96, 5), ("ring", 1, 64, 64, 0)])
def test_flood_kernel_matches_plain_version(cuda, form, case):
    kind, b, h, w, cap = case
    make = _flood_random if kind == "random" else _flood_ring
    seed, within = make(np.random.default_rng(b * h + w), b, h, w)
    s = torch.from_numpy(seed).to(cuda)
    m = torch.from_numpy(within).to(cuda)
    cap = h * w if cap is None else cap
    counter = "launches" if form == "shared" else "global_launches"
    before = getattr(flood, counter)
    out, steps = flood.flood(s, m, cap, return_steps=True, form=form)
    torch.cuda.synchronize()
    assert getattr(flood, counter) > before
    want, want_steps = flood.flood_plain(torch.from_numpy(seed),
                                         torch.from_numpy(within), cap,
                                         return_steps=True)
    assert out.dtype == torch.bool and out.shape == (b, h, w)
    assert torch.equal(out.cpu(), want)
    assert torch.equal(steps.cpu(), want_steps)


@pytest.mark.gpu
def test_flood_picks_the_global_form_past_shared_memory(cuda):
    seed, within = _flood_random(np.random.default_rng(5), 2, 1024, 1400,
                                 p=0.6)
    assert flood.shared_bytes(1024, 1400) > flood.smem_limit(cuda)
    s = torch.from_numpy(seed).to(cuda)
    m = torch.from_numpy(within).to(cuda)
    before = (flood.launches, flood.global_launches)
    out = flood.flood(s, m, 1024 * 1400)
    torch.cuda.synchronize()
    assert flood.launches == before[0]
    assert flood.global_launches > before[1]
    # the plain version on the card too: 1024x1400 takes thousands of steps
    assert torch.equal(out, flood.flood_plain(s, m, 1024 * 1400))
    with pytest.raises(ValueError):
        flood.flood(s, m, 10, form="shared")


@pytest.mark.gpu
def test_flood_one_launch_per_call_in_shared_memory(cuda):
    seed, within = _flood_random(np.random.default_rng(6), 8, 48, 96)
    s = torch.from_numpy(seed).to(cuda)
    m = torch.from_numpy(within).to(cuda)
    before = (flood.launches, flood.global_launches)
    for k in range(3):
        flood.flood(s, m, 48 * 96)
        assert flood.launches == before[0] + k + 1
    assert flood.global_launches == before[1]


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
    before = (flood.launches, flood.global_launches)
    out, steps = flood.flood(empty, empty, 100, return_steps=True)
    assert out.shape == (0, 48, 96) and steps.shape == (0,)
    assert (flood.launches, flood.global_launches) == before
