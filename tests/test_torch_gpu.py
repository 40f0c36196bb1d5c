"""Kernels on the card against their plain versions (K1,
``csrc/resize_pad.cu``, in its eval and train forms; K2, ``csrc/flood.cu``),
and one mixed train step on the card. These need a CUDA card: a
CUDA kernel has no CPU mode, so here they skip. The file imports neither JAX
nor the repo's ``conftest.py`` fixtures, so it also runs on a machine
without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: K1 in float32 within 1e-3/255 of the plain version (the kernel
repeats its float steps one by one, so in practice they agree exactly), in
bfloat16 within one bf16 ulp of the plain version cast to bf16, on the 0-255
scale (``raw``) within 1e-3; K2 exact (bool masks, and the same step count
per image), in each of its three forms. The other model families: the eval
forward on the card (float32, TF32 off) against the CPU within ``rtol=1e-4,
atol=1e-5`` of the logits; a train step with the rotation warp on the card.
"""

import numpy as np
import pytest
import torch

from sykepic_tpu_torch.ingest import pack
from sykepic_tpu_torch.ops import augment, flood, preprocess, resize_pad

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


def _train_inputs(rng, bucket, r=256, n=64):
    """K1 train-form inputs on one canvas bucket: ``n`` stored images read
    by ``r`` slots (rows repeat, as a store is read in place), affines with
    both flips, zoom 0.6, 1.4 and drawn, translations at -limit, +limit
    and drawn, brightness in [0.95, 1.1]."""
    bh, bw = bucket
    hs = rng.integers(1, min(bh, 180) + 1, n)
    ws = rng.integers(1, min(bw, 180) + 1, n)
    canvas = rng.integers(0, 256, (n, bh, bw), dtype=np.uint8)
    geom = preprocess.compute_geometry(hs, ws, 180, 180)
    border = rng.integers(0, 256, n)
    rows = rng.integers(0, n, r)
    meta = np.ascontiguousarray(preprocess.slot_meta(
        hs, ws, *geom, border, win_idx=np.arange(n))[:, rows])
    lim_x, lim_y = augment.translate_limits(hs, ws, geom[0], geom[1], 180,
                                            180)
    lim_x, lim_y = lim_x[rows], lim_y[rows]
    sign = rng.choice([-1, 1, 0], r)
    tx = np.where(sign == 0, rng.integers(-lim_x, lim_x + 1), sign * lim_x)
    ty = np.where(sign == 0, rng.integers(-lim_y, lim_y + 1), sign * lim_y)
    f = np.choose(rng.integers(0, 3, r),
                  [np.full(r, 0.6), np.full(r, 1.4),
                   np.round(rng.uniform(0.6, 1.4, r), 2)])
    draws = augment.Draws(
        torch.from_numpy(rng.random(r) < 0.5),
        torch.from_numpy(rng.random(r) < 0.5),
        torch.from_numpy(tx.astype(np.float32)),
        torch.from_numpy(ty.astype(np.float32)),
        torch.from_numpy(f.astype(np.float32)),
        torch.from_numpy(rng.uniform(0.95, 1.1, r).astype(np.float32)))
    return canvas, meta, augment.affine_rows(draws, 180, 180), draws.bright


_NORM = (torch.tensor(preprocess.IMAGENET_MEAN),
         torch.tensor(preprocess.IMAGENET_STD))


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", [b for b in pack.DEFAULT_BUCKETS
                                    if b[0] <= 192 and b[1] <= 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bright,norm", [(True, False), (False, True),
                                         (True, True)])
def test_train_form_matches_plain_version(cuda, bucket, dtype, bright, norm):
    canvas, meta, affine, br = _train_inputs(
        np.random.default_rng(bucket[0] * bucket[1]), bucket)
    kw = dict(affine=affine, bright=br if bright else None,
              mean=_NORM[0] if norm else None,
              std=_NORM[1] if norm else None)
    on_card = {k: None if v is None else v.to(cuda) for k, v in kw.items()}
    before = (resize_pad.launches, resize_pad.train_launches)
    out = resize_pad.resize_pad(torch.from_numpy(canvas).to(cuda),
                                torch.from_numpy(meta).to(cuda), 180, 180, 3,
                                dtype, **on_card)
    torch.cuda.synchronize()
    assert (resize_pad.launches, resize_pad.train_launches) == (
        before[0], before[1] + 1)
    plain = preprocess.resize_pad_plain(torch.from_numpy(canvas),
                                        torch.from_numpy(meta), 180, 180, 3,
                                        **kw)
    err = (out.cpu().float() - plain.to(dtype).float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= ATOL
    else:
        assert bool((err <= plain.to(dtype).float().abs() * 2.0 ** -7).all())


@pytest.mark.gpu
def test_train_form_identity_affine_is_the_eval_form(cuda):
    # q = 1 * i + 0 is the iota exactly: the train form without an
    # augmentation writes the eval form's bits
    canvas, meta, _, _ = _train_inputs(np.random.default_rng(3), (96, 128))
    r = meta.shape[1]
    ident = torch.stack([torch.ones(r), torch.zeros(r), torch.ones(r),
                         torch.zeros(r)]).to(cuda)
    pix = torch.from_numpy(canvas).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        a = resize_pad.resize_pad(pix, m, 180, 180, 3, dtype)
        b = resize_pad.resize_pad(pix, m, 180, 180, 3, dtype, affine=ident)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_train_form_writes_into_a_slice(cuda):
    canvas, meta, affine, br = _train_inputs(np.random.default_rng(4),
                                             (64, 128), r=40)
    pix = torch.from_numpy(canvas).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    out = torch.full((50, 180, 180, 3), -1.0, device=cuda)
    got = resize_pad.resize_pad(pix, m, 180, 180, 3, affine=affine.to(cuda),
                                bright=br.to(cuda), out=out[5:45])
    assert got.data_ptr() == out[5:45].data_ptr()
    assert bool((out[:5] == -1).all()) and bool((out[45:] == -1).all())
    want = resize_pad.resize_pad(pix, m, 180, 180, 3, affine=affine.to(cuda),
                                 bright=br.to(cuda))
    assert torch.equal(out[5:45], want)
    with pytest.raises(ValueError):
        resize_pad.resize_pad(pix, m, 180, 180, 3, affine=affine)  # on CPU
    with pytest.raises(ValueError):
        resize_pad.resize_pad(pix, m, 180, 180, 3, mean=_NORM[0].to(cuda))


@pytest.mark.gpu
def test_mixed_train_step_on_the_card(cuda, tmp_path):
    from sykepic_tpu_torch.models import registry
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.device_data import DeviceDataset
    from sykepic_tpu_torch.train.trainer import Trainer
    from sykepic_tpu_torch.utils import png

    rng = np.random.default_rng(5)
    paths, labels = [], []
    for i in range(48):
        cls = i % 2
        h, w = ((rng.integers(10, 30), rng.integers(12, 40)) if cls == 0
                else (rng.integers(70, 120), rng.integers(70, 120)))
        p = tmp_path / f"img_{i:03}.png"
        png.write_png(p, rng.integers(0, 256, (h, w), dtype=np.uint8))
        paths.append(p)
        labels.append(cls)
    spec = PreprocessSpec(180, 180, 3, border="mode")
    ds = DeviceDataset(paths, labels, spec, batch_size=16, seed=0,
                       shuffle=True, device=cuda)
    assert ds._use_mixed
    model = registry.init_weights(
        registry.build_model("resnet18", 2, head=(256, 128)), 0)
    trainer = Trainer(model, optimizer="Adam", preprocess_spec=spec,
                      augment_kwargs=augment.spec_kwargs(
                          ("flip", "translate", "zoom", "brightness"),
                          (0.6, 1.4), (0.95, 1.1), 0),
                      device=cuda, dtype="bfloat16")
    before = resize_pad.train_launches
    batch = next(iter(ds))
    loss, correct, n = trainer.train_batch(batch, 0, (1e-3, 0.0, 0.0))
    torch.cuda.synchronize()
    assert resize_pad.train_launches == before + len(batch.stores)
    assert np.isfinite(float(loss)) and float(n) == float(batch.weights.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_slots, _shelf])
def test_raw_form_matches_plain_version(cuda, make):
    pixels, meta = make(np.random.default_rng(4))
    pix = torch.from_numpy(pixels).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    before = resize_pad.launches
    got = resize_pad.resize_pad(pix, m, 180, 180, 1, raw=True)
    torch.cuda.synchronize()
    assert resize_pad.launches == before + 1
    want = preprocess.resize_pad_plain(pix, m, 180, 180, 1, raw=True)
    assert float(got.max()) > 1.0
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["efficientnet_b0", "efficientnet_v2_s",
                                  "mobilenet_v3_large", "vgg16_bn", "alexnet",
                                  "convnext_tiny", "regnet_y_400mf"])
def test_family_forward_card_against_cpu(cuda, name):
    from sykepic_tpu_torch.models import registry

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = registry.init_weights(registry.build_model(name, 50), 0).eval()
    x = torch.rand(8, 3, 180, 180, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        model = model.to(cuda, memory_format=torch.channels_last)
        got = model(x.to(cuda).contiguous(
            memory_format=torch.channels_last)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_rotation_train_step_on_the_card(cuda, tmp_path):
    from sykepic_tpu_torch.models import registry
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.device_data import DeviceDataset
    from sykepic_tpu_torch.train.trainer import Trainer
    from sykepic_tpu_torch.utils import png

    rng = np.random.default_rng(6)
    paths, labels = [], []
    for i in range(32):
        h, w = rng.integers(10, 120, 2)
        p = tmp_path / f"img_{i:03}.png"
        png.write_png(p, rng.integers(0, 256, (h, w), dtype=np.uint8))
        paths.append(p)
        labels.append(i % 2)
    spec = PreprocessSpec(180, 180, 3, border="mode")
    ds = DeviceDataset(paths, labels, spec, batch_size=16, seed=0,
                       shuffle=True, device=cuda)
    model = registry.init_weights(
        registry.build_model("efficientnet_b0", 2, head=(256, 128)), 0)
    trainer = Trainer(model, optimizer="Adam", preprocess_spec=spec,
                      augment_kwargs=augment.spec_kwargs(
                          ("flip", "translate", "zoom", "rotate",
                           "brightness"), (0.6, 1.4), (0.95, 1.1), 10),
                      device=cuda, dtype="bfloat16")
    before = (resize_pad.launches, resize_pad.train_launches)
    batch = next(iter(ds))
    loss, _, n = trainer.train_batch(batch, 0, (1e-3, 0.0, 0.0))
    torch.cuda.synchronize()
    parts = len(getattr(batch, "stores", (None,)))
    # the rotation route: K1's eval form (0-255 scale), one launch a part
    assert (resize_pad.launches, resize_pad.train_launches) == (
        before[0] + parts, before[1])
    assert np.isfinite(float(loss)) and float(n) > 0
