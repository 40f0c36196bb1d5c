"""Kernels on the card against their plain versions (K1,
``csrc/resize_pad.cu``). These need a CUDA card: a CUDA kernel has no CPU
mode, so here they skip. The file imports neither JAX nor the repo's
``conftest.py`` fixtures, so it also runs on a machine without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: float32 within 1e-3/255 of the plain version (the kernel repeats
its float steps one by one, so in practice they agree exactly); bfloat16
within one bf16 ulp of the plain version cast to bf16.
"""

import numpy as np
import pytest
import torch

from sykepic_tpu_torch.ops import preprocess, resize_pad

ATOL = 1e-3 / 255


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
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
