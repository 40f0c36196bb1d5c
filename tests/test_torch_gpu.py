"""Kernels on the card against their plain versions (K1,
``csrc/resize_pad.cu``, in its eval and train forms; K2, ``csrc/flood.cu``),
and one mixed train step on the card. These need a CUDA card: a
CUDA kernel has no CPU mode, so here they skip. The file imports neither JAX
nor the repo's ``conftest.py`` fixtures, so it also runs on a machine
without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: K1 exact (max |diff| 0.0) against its plain version run on the
same card, in every form, dtype, target shape, channel count and store path
(the kernel repeats the plain version's float steps one by one, and the
level table runs the same steps once a level); K2 exact (bool masks, and the
same step count per image), in each of its three forms. The other model
families: the eval forward on the card (float32, TF32 off) against the CPU
within ``rtol=1e-4, atol=1e-5`` of the logits; a train step with the
rotation warp on the card. Multi-GPU at world size 1 (a NCCL group over the
one card): a data-parallel mixed train step equals the step without a group
(cuDNN deterministic; loss within 1e-5 relative), and ``prob`` through
``Classifier(mesh=)`` equals the run without a mesh (within 1.2e-5, the same
ids), K1 launched on both. The float32 eval model's memory format: in
NCHW (ResNet18) a shelf dispatch launches none of cuDNN's NHWC<->NCHW
transposes, channels_last (kept by EfficientNet-B0) launches them, and the
probabilities of the two formats agree within the benchmark cells' bounds
(5e-5 ResNet18, 5e-4 EfficientNet-B0). ConvNeXt's eval LayerNorm kernel
(``csrc/layernorm.cu``) against its plain version and ``F.layer_norm`` on
the card within 1e-5 absolute (outputs below 8; float32 sums in another
order, rsqrtf within 2 ulp), at widths that reach each of its instances and
at ConvNeXt-T's stage-1 dispatch; one launch a call, under a name holding
``layernorm``; ConvNeXt-T's eval forward with the kernel against ATen's
LayerNorm, probabilities within 1e-5. The eval depthwise convolution kernel
(``csrc/depthwise.cu``) against its plain version and ``F.conv2d`` (cuDNN,
TF32 off) within 1e-5 absolute plus 1e-5 relative (float32 sums of k^2
products in another order, one rounding a tap against two; outputs below
8), at every instance and at ConvNeXt-T's and EfficientNet-B0's shapes,
ConvNeXt-T's stage-1 dispatch among them; one launch a call, under a name
that holds ``depthwise`` and none of the benchmark readers' words; and
ConvNeXt-T's and EfficientNet-B0's eval forwards with it against ATen's,
probabilities within 1e-5. Swin-T's eval forward at 180 px against the
benchmark's plain reference (``bench_port/reference/nets/swin_t.py``, TF32
off) within 1e-5 of the logits' spread, with 29 LayerNorm kernel launches
and one SDPA kernel a block (12) a forward.
"""

import numpy as np
import pytest
import torch

from sykepic_tpu_torch.ingest import pack
from sykepic_tpu_torch.ops import (augment, depthwise, flood, layernorm,
                                   preprocess, resize_pad)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _slots(rng, b=32, ch=64, cw=128, target=(180, 180)):
    hs = rng.integers(1, ch + 1, b)
    ws = rng.integers(1, cw + 1, b)
    canvas = rng.integers(0, 256, (b, ch, cw), dtype=np.uint8)
    geom = preprocess.compute_geometry(hs, ws, *target)
    border = rng.integers(0, 256, b)
    return canvas, preprocess.slot_meta(hs, ws, *geom, border)


def _shelf(rng, nc=4, r=300, target=(180, 180)):
    wins = rng.integers(0, 256, (nc, 192, 512), dtype=np.uint8)
    hs = rng.integers(1, 181, r)
    ws = rng.integers(1, 181, r)
    y0 = (rng.random(r) * (192 - hs)).astype(np.int32)
    x0 = (rng.random(r) * (512 - ws)).astype(np.int32)
    geom = preprocess.compute_geometry(hs, ws, *target)
    border = rng.integers(0, 256, r)
    return wins, preprocess.slot_meta(hs, ws, *geom, border,
                                      rng.integers(0, nc, r), y0, x0)


def _one_slot(rng, target=(180, 180)):
    return _slots(rng, b=1, target=target)


def _shelf_2048(rng, target=(180, 180)):
    return _shelf(rng, nc=16, r=2048, target=target)


def _assert_exact(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err == 0.0, f"max |diff| {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("make,target,chans", [
    (_slots, (180, 180), 3), (_shelf, (180, 180), 3),
    (_one_slot, (180, 180), 3), (_shelf_2048, (180, 180), 3),
    # odd widths (an odd row span: the vector store), a partial last tile
    (_slots, (180, 179), 3), (_shelf, (97, 33), 3), (_slots, (181, 180), 3),
    (_slots, (180, 180), 1), (_shelf, (97, 33), 1),
    (_slots, (180, 180), 8), (_shelf, (180, 179), 8),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, make, target, chans, dtype):
    pixels, meta = make(np.random.default_rng(0), target=target)
    pix = torch.from_numpy(pixels).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    th, tw = target
    before = resize_pad.launches
    out = resize_pad.resize_pad(pix, m, th, tw, chans, dtype)
    torch.cuda.synchronize()
    assert resize_pad.launches == before + 1
    assert out.shape == (meta.shape[1], th, tw, chans) and out.dtype == dtype
    _assert_exact(out, preprocess.resize_pad_plain(pix, m, th, tw, chans,
                                                   dtype))


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
# brightness (the level table) with and without mean/std, and mean/std
# alone; eight channels take an eight-entry level of the table
@pytest.mark.parametrize("bright,norm,chans", [
    (True, False, 3), (False, True, 3), (True, True, 3), (True, True, 8)])
def test_train_form_matches_plain_version(cuda, bucket, dtype, bright, norm,
                                          chans):
    canvas, meta, affine, br = _train_inputs(
        np.random.default_rng(bucket[0] * bucket[1]), bucket)
    mean, std = _NORM
    if chans != 3:
        g = np.random.default_rng(chans)
        mean = torch.from_numpy(g.uniform(0.3, 0.6, chans).astype(np.float32))
        std = torch.from_numpy(g.uniform(0.2, 0.3, chans).astype(np.float32))
    kw = dict(affine=affine, bright=br if bright else None,
              mean=mean if norm else None, std=std if norm else None)
    on_card = {k: None if v is None else v.to(cuda) for k, v in kw.items()}
    pix = torch.from_numpy(canvas).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    before = (resize_pad.launches, resize_pad.train_launches)
    out = resize_pad.resize_pad(pix, m, 180, 180, chans, dtype, **on_card)
    torch.cuda.synchronize()
    assert (resize_pad.launches, resize_pad.train_launches) == (
        before[0], before[1] + 1)
    _assert_exact(out, preprocess.resize_pad_plain(pix, m, 180, 180, chans,
                                                   dtype, **on_card))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# shift: elements ahead of the slice in its buffer; one element breaks the
# 16-byte alignment a bulk store needs, so the vector path writes it
@pytest.mark.parametrize("shift", [0, 1])
def test_train_form_writes_into_a_slice(cuda, dtype, shift):
    canvas, meta, affine, br = _train_inputs(np.random.default_rng(4),
                                             (64, 128), r=40)
    pix = torch.from_numpy(canvas).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    n = 180 * 180 * 3
    buf = torch.full((50 * n + shift,), -1.0, dtype=dtype, device=cuda)
    out = buf[shift:].view(50, 180, 180, 3)
    kw = dict(affine=affine.to(cuda), bright=br.to(cuda))
    vector = resize_pad.vector_launches
    got = resize_pad.resize_pad(pix, m, 180, 180, 3, dtype, out=out[5:45],
                                **kw)
    assert got.data_ptr() == out[5:45].data_ptr()
    assert resize_pad.vector_launches == vector + shift
    assert bool((buf[:shift + 5 * n] == -1).all())
    assert bool((buf[shift + 45 * n:] == -1).all())
    _assert_exact(out[5:45], preprocess.resize_pad_plain(
        pix, m, 180, 180, 3, dtype, **kw))
    want = resize_pad.resize_pad(pix, m, 180, 180, 3, dtype, **kw)
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
    _assert_exact(got, want)


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


def _kernel_names(fn) -> list:
    """Names of the device kernels that ``fn`` launches, from the raw
    trace events of torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == dev]


@pytest.mark.gpu
@pytest.mark.parametrize("name,bound,picked", [
    ("resnet18", 5e-5, torch.contiguous_format),
    # depthwise convolutions keep channels_last
    ("efficientnet_b0", 5e-4, torch.channels_last)])
def test_float32_eval_memory_format_on_the_card(cuda, tmp_path, name, bound,
                                                picked):
    """A float32 ``Classifier``'s shelf dispatch in the format it picks
    against the same model in the other format: the NCHW run launches none
    of cuDNN's NHWC<->NCHW transposes, the channels_last run does, and the
    probabilities agree within the benchmark cell's bound."""
    from torch_model_dirs import family_model_dir

    from sykepic_tpu_torch.compute import engine

    clf = engine.Classifier(family_model_dir(tmp_path, name),
                            batch_size=2048, device=cuda)
    assert clf.memory_format == picked
    rng = np.random.default_rng(7)
    rois = [(0, i + 1, rng.integers(0, 256, tuple(rng.integers(8, 160, 2)),
                                    dtype=np.uint8)) for i in range(2048)]
    batch = next(iter(clf._packed(rois)))
    meta = clf._shelf_meta(batch)
    transposes = ("nhwcToNchw", "nchwToNhwc")
    other = (torch.channels_last if picked == torch.contiguous_format
             else torch.contiguous_format)

    def run():
        rows = clf.dispatch_shelf(batch, meta)
        return engine.unpack_probs_u16(rows.cpu().numpy(), len(clf.classes))

    probs = {}
    for fmt in (picked, other):
        clf.memory_format = fmt
        clf.model.to(memory_format=fmt)
        probs[fmt] = run()[:batch.n_valid]  # warm: cuDNN's plans
        names = _kernel_names(run)
        moved = [k for k in names if any(t in k for t in transposes)]
        assert names and bool(moved) == (fmt == torch.channels_last), moved
    got, want = probs.values()
    assert np.abs(got - want).max() <= bound


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


@pytest.mark.gpu
def test_nccl_world_one_trainer_and_engine(cuda, tmp_path):
    import copy
    from pathlib import Path

    from sykepic_tpu_torch import parallel
    from sykepic_tpu_torch.compute import probability
    from sykepic_tpu_torch.models import registry
    from sykepic_tpu_torch.parallel import dryrun
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.device_data import DeviceDataset
    from sykepic_tpu_torch.train.trainer import Trainer
    from sykepic_tpu_torch.utils import png

    rng = np.random.default_rng(6)
    paths, labels = [], []
    for i in range(40):
        h, w = rng.integers(10, 120, 2)
        p = tmp_path / f"img_{i:03}.png"
        png.write_png(p, rng.integers(0, 256, (h, w), dtype=np.uint8))
        paths.append(p)
        labels.append(i % 3)
    spec = PreprocessSpec(180, 180, 3, border="mode")
    ds = DeviceDataset(paths, labels, spec, batch_size=16, seed=0,
                       shuffle=True, device=cuda)
    batch = next(iter(ds))
    model = registry.init_weights(
        registry.build_model("resnet18", 3, head=(256, 128)), 0)
    aug = augment.spec_kwargs(("flip", "translate", "zoom", "brightness"),
                              (0.6, 1.4), (0.95, 1.1), 0)
    mdir = dryrun.build_model_dir(tmp_path)
    fixture = Path(dryrun.FIXTURE)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = Trainer(copy.deepcopy(model), "Adam", spec, aug, seed=1,
                        device=cuda, dtype="bfloat16")
        want = [float(v) for v in plain.train_batch(batch, 2,
                                                    (1e-3, 1e-4, 1e-5))]
        probability.main([fixture], mdir, tmp_path / "plain", 4,
                         progress_bar=False)
        dev = parallel.init_process_group("cuda", tmp_path / "store", 0, 1)
        try:
            mesh = parallel.data_mesh()
            before = resize_pad.train_launches
            dp = Trainer(copy.deepcopy(model), "Adam", spec, aug, seed=1,
                         device=dev, dtype="bfloat16", mesh=mesh)
            got = [float(v) for v in dp.train_batch(batch, 2,
                                                    (1e-3, 1e-4, 1e-5))]
            assert resize_pad.train_launches == before + len(batch.stores)
            before = resize_pad.launches
            probability.main([fixture], mdir, tmp_path / "mesh", 4,
                             progress_bar=False, mesh=mesh)
            torch.cuda.synchronize()
            assert resize_pad.launches > before
        finally:
            parallel.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = det
    assert got[2] == want[2] and got[1] == want[1]
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    (a,) = dryrun.csv_paths(tmp_path, "plain")
    pa = dryrun.read_prob_csv(a)
    pb = dryrun.read_prob_csv(tmp_path / "mesh" / a.relative_to(
        tmp_path / "plain"))
    assert pa.keys() == pb.keys() and pa
    assert max(float(np.abs(pa[r] - pb[r]).max()) for r in pa) <= 1.2e-5


# widths that reach every instance of the LayerNorm kernel (1 to 12 float4
# a lane), ConvNeXt-T's four among them
LN_WIDTHS = (4, 8, 12, 96, 100, 192, 384, 640, 768, 800, 1024, 1100, 1240,
             1400, 1536)
LN_TOL = 1e-5


def _ln_inputs(shape, c, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = 2 * torch.randn(*shape, c, generator=g, device=device) + 0.5
    w = 1 + 0.1 * torch.randn(c, generator=g, device=device)
    b = 0.1 * torch.randn(c, generator=g, device=device)
    pb = 0.5 * torch.randn(c, generator=g, device=device)
    return x, w, b, pb


def _ln_check(x, w, b, pb):
    from torch.nn import functional as F

    c = x.shape[-1]
    got = layernorm.layernorm(x, w, b, 1e-6, pre_bias=pb)
    plain = layernorm.layernorm_plain(x, w, b, 1e-6, pre_bias=pb)
    library = F.layer_norm(x if pb is None else x + pb, (c,), w, b, 1e-6)
    torch.testing.assert_close(got, plain, rtol=0, atol=LN_TOL)
    torch.testing.assert_close(got, library, rtol=0, atol=LN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("c", LN_WIDTHS)
@pytest.mark.parametrize("pre", [False, True])
def test_layernorm_kernel_matches_plain_version(cuda, c, pre):
    x, w, b, pb = _ln_inputs((5, 7, 13), c, c, cuda)  # 455 rows: ragged
    _ln_check(x, w, b, pb if pre else None)


@pytest.mark.gpu
@pytest.mark.parametrize("pre", [False, True])
def test_layernorm_kernel_at_the_stage_1_dispatch(cuda, pre):
    """ConvNeXt-T's stage 1 at a 2,048-slot dispatch: 4.1M rows of 96."""
    x, w, b, pb = _ln_inputs((2048, 45, 45), 96, 1, cuda)
    _ln_check(x, w, b, pb if pre else None)


@pytest.mark.gpu
def test_layernorm_one_launch_per_call_named_layernorm(cuda):
    x, w, b, pb = _ln_inputs((64, 9, 9), 192, 2, cuda)

    sentinel = torch.zeros(1, device=cuda)

    def calls():
        # torch.profiler has been seen to drop the first kernel of a
        # profile on the card: a fill goes first, and only it may be dropped
        sentinel.fill_(1.0)
        return [layernorm.layernorm(x, w, b, 1e-6, pre_bias=p)
                for p in (pb, None, pb)]

    calls()
    torch.cuda.synchronize()
    n0 = layernorm.launches
    names = _kernel_names(calls)
    assert layernorm.launches - n0 == 3
    ours = [n for n in names if "layernorm" in n]
    assert len(ours) == 3 and len(names) - len(ours) <= 1, names
    assert not any("gelu" in n or "resize_pad" in n for n in ours)
    empty = layernorm.layernorm(x[:0], w, b, 1e-6)
    assert empty.shape == (0, 9, 9, 192) and layernorm.launches - n0 == 3


@pytest.mark.gpu
def test_layernorm_rejects_what_it_does_not_take(cuda):
    x, w, b, pb = _ln_inputs((4, 8), 96, 3, cuda)
    bad = [
        (x.transpose(0, 1), w, b, None),  # not contiguous
        (x.double(), w.double(), b.double(), None),  # float64
        (x[..., :94].contiguous(), w[:94], b[:94], None),  # C % 4 != 0
        (torch.zeros(2, 1540, device=cuda), torch.ones(1540, device=cuda),
         torch.zeros(1540, device=cuda), None),  # past 1536
        (x, w[:48], b, None),  # weight of another width
        (x, w, b, pb.cpu()),  # pre_bias on another device
        # contiguous, but one float past 16-byte alignment
        (torch.zeros(4 * 8 * 96 + 1, device=cuda)[1:].view(4, 8, 96), w, b,
         None),
    ]
    n0 = layernorm.launches
    for args in bad:
        with pytest.raises(ValueError):
            layernorm.layernorm(*args[:3], 1e-6, pre_bias=args[3])
    assert layernorm.launches == n0


@pytest.mark.gpu
def test_convnext_eval_forward_kernel_against_aten(cuda, monkeypatch):
    """ConvNeXt-T's eval forward on the card, channels_last: 22 kernel
    launches a forward, and its probabilities within 1e-5 of the same
    forward on ATen's LayerNorm (the rule patched off)."""
    import math

    from sykepic_tpu_torch.models import convnext, registry

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model = registry.init_weights(registry.build_model("convnext_tiny", 50),
                                  0)
    with torch.no_grad():  # block scales of 1, so the blocks count
        for m in model.modules():
            if isinstance(m, convnext.CNBlock):
                m.layer_scale.fill_(1.0)
    model = model.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.rand(16, 3, 180, 180, generator=torch.Generator().manual_seed(2))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)

    def probs():
        with torch.inference_mode():
            return torch.softmax(model(x) * math.log(1.3), dim=-1).cpu()

    n0 = layernorm.launches
    got = probs()
    assert layernorm.launches - n0 == 22
    monkeypatch.setattr(convnext, "eval_kernel_runs", lambda *a: False)
    want = probs()
    assert layernorm.launches - n0 == 22
    assert float((got - want).abs().max()) <= 1e-5


# (k, stride, height, width, channels): ConvNeXt-T's four shapes and
# EfficientNet-B0's twelve of a 180x180 input, then odd and ragged ones
# (maps smaller than the filter, part slices of channels); between them
# they reach every instance of the kernel
DW_CASES = (
    (7, 1, 45, 45, 96), (7, 1, 22, 22, 192), (7, 1, 11, 11, 384),
    (7, 1, 5, 5, 768), (3, 1, 90, 90, 32), (3, 2, 90, 90, 96),
    (3, 1, 45, 45, 144), (5, 2, 45, 45, 144), (5, 1, 23, 23, 240),
    (3, 2, 23, 23, 240), (3, 1, 12, 12, 480), (5, 1, 12, 12, 480),
    (5, 1, 12, 12, 672), (5, 2, 12, 12, 672), (5, 1, 6, 6, 1152),
    (3, 1, 6, 6, 1152), (3, 1, 1, 1, 4), (3, 2, 1, 2, 8), (5, 2, 2, 3, 4),
    (7, 1, 3, 1, 12), (5, 1, 7, 4, 20), (3, 2, 9, 13, 36), (7, 1, 13, 6, 44),
    (5, 2, 17, 10, 100), (3, 1, 5, 31, 68), (7, 1, 30, 17, 52))
DW_TOL = 1e-5
# substrings the benchmark's readers match in kernel names
READER_WORDS = ("layer_norm", "layernorm", "RowwiseMoments", "gelu",
                "resize_pad")


def _dw_inputs(n, h, w, c, k, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g, device=device)
    weight = torch.randn(c, 1, k, k, generator=g, device=device) / k
    return x, weight


def _dw_check(x, weight, stride):
    from torch.nn import functional as F

    k = weight.shape[-1]
    got = depthwise.depthwise(x, weight, stride)
    plain = depthwise.depthwise_plain(x, weight, stride)
    torch.testing.assert_close(got, plain, rtol=DW_TOL, atol=DW_TOL)
    del plain
    library = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride,
                       padding=(k - 1) // 2, groups=x.shape[-1])
    assert got.is_contiguous()
    torch.testing.assert_close(got, library.permute(0, 2, 3, 1),
                               rtol=DW_TOL, atol=DW_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("k,stride,h,w,c", DW_CASES)
def test_depthwise_kernel_matches_plain_version_and_conv2d(
        cuda, monkeypatch, k, stride, h, w, c):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, weight = _dw_inputs(8, h, w, c, k, k * 1000 + h + c, cuda)
    _dw_check(x, weight, stride)


@pytest.mark.gpu
def test_depthwise_kernel_at_the_stage_1_dispatch(cuda, monkeypatch):
    """ConvNeXt-T's stage 1 at a 2,048-slot dispatch: 2048 x 45x45 x 96."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, weight = _dw_inputs(2048, 45, 45, 96, 7, 1, cuda)
    _dw_check(x, weight, 1)


@pytest.mark.gpu
def test_depthwise_one_launch_per_call_named_depthwise(cuda):
    x, weight = _dw_inputs(64, 11, 11, 384, 7, 2, cuda)
    x2, weight2 = _dw_inputs(64, 23, 23, 240, 5, 3, cuda)
    sentinel = torch.zeros(1, device=cuda)

    def calls():
        # torch.profiler has been seen to drop the first kernel of a
        # profile on the card: a fill goes first, and only it may be dropped
        sentinel.fill_(1.0)
        return [depthwise.depthwise(x, weight, 1),
                depthwise.depthwise(x2, weight2, 2),
                depthwise.depthwise(x, weight, 1)]

    n0 = depthwise.launches
    calls()
    torch.cuda.synchronize()
    assert depthwise.launches - n0 == 3
    # in a run of the whole file on the card, torch.profiler has been seen
    # to record no event at all, the sentinel's fill included: profile again
    for _ in range(3):
        names = _kernel_names(calls)
        if names:
            break
    ours = [n for n in names if "depthwise" in n]
    assert len(ours) == 3 and len(names) - len(ours) <= 1, names
    assert not any(word in n for n in ours for word in READER_WORDS)
    n0 = depthwise.launches
    empty = depthwise.depthwise(x[:0], weight, 1)
    assert empty.shape == (0, 11, 11, 384)
    assert depthwise.launches == n0


@pytest.mark.gpu
def test_depthwise_rejects_what_it_does_not_take(cuda):
    x, weight = _dw_inputs(2, 9, 9, 96, 3, 4, cuda)
    bad = [
        (x.transpose(1, 2), weight, 1),  # not contiguous
        (x.double(), weight.double(), 1),  # float64
        (x[..., :94].contiguous(), weight[:94], 1),  # C % 4 != 0
        (x, torch.zeros(96, 1, 4, 4, device=cuda), 1),  # k even
        (x, torch.zeros(96, 1, 9, 9, device=cuda), 1),  # k past 7
        (x, torch.zeros(96, 1, 7, 7, device=cuda), 2),  # 7x7 at stride 2
        (x, weight, 3),  # stride 3
        (x, weight[:48], 1),  # weight of another width
        (x, torch.zeros(96, 2, 3, 3, device=cuda), 1),  # not depthwise
        (x, weight.cpu(), 1),  # weight on another device
        (x[0], weight, 1),  # not 4-D
        (x[:, :0], weight, 1),  # an empty map
        # contiguous, but one float past 16-byte alignment
        (torch.zeros(2 * 9 * 9 * 96 + 1, device=cuda)[1:].view(2, 9, 9, 96),
         weight, 1),
    ]
    n0 = depthwise.launches
    for args in bad:
        with pytest.raises(ValueError):
            depthwise.depthwise(*args)
    assert depthwise.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("name,per_forward", [("convnext_tiny", 18),
                                              ("efficientnet_b0", 16)])
def test_eval_forward_depthwise_kernel_against_aten(cuda, monkeypatch, name,
                                                    per_forward):
    """An eval forward on the card, channels_last: the depthwise kernel
    launched once a depthwise convolution, and the probabilities within
    1e-5 of the same forward on ATen's path (the rule patched off)."""
    import math

    from sykepic_tpu_torch.models import convnext, layers, registry

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model = registry.init_weights(registry.build_model(name, 50), 0)
    with torch.no_grad():  # block scales of 1, so the blocks count
        for m in model.modules():
            if isinstance(m, convnext.CNBlock):
                m.layer_scale.fill_(1.0)
    model = model.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.rand(16, 3, 180, 180, generator=torch.Generator().manual_seed(2))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)

    def probs():
        with torch.inference_mode():
            return torch.softmax(model(x) * math.log(1.3), dim=-1).cpu()

    n0 = depthwise.launches
    got = probs()
    assert depthwise.launches - n0 == per_forward
    monkeypatch.setattr(layers, "eval_kernel_runs", lambda *a: False)
    monkeypatch.setattr(convnext, "eval_kernel_runs", lambda *a: False)
    want = probs()
    assert depthwise.launches - n0 == per_forward
    assert float((got - want).abs().max()) <= 1e-5


# Swin-T's logits on the card against the plain reference's, as a share of
# their spread: float32 throughout, sums in another order (the attention in
# SDPA's memory-efficient kernel, LayerNorm in the port's kernel); an H100
# gave 3.0e-6 of the spread, the CPU 1.3e-6 to 4.6e-6 on a small Swin
# (tests/test_torch_swin.py)
SWIN_LOGIT_TOL = 1e-5
SWIN_ATTENTION_WORDS = ("fmha", "attention", "flash")


@pytest.mark.gpu
def test_swin_t_eval_forward_against_the_plain_reference(cuda):
    """Swin-T at its published widths on the card, 64 images at 180 px in
    channels_last, weights of the benchmark's seeded rule: the logits
    within ``SWIN_LOGIT_TOL`` of their spread of the plain reference's (TF32
    off); the LayerNorm kernel launched 29 times a forward; and one SDPA
    kernel a block (12) in a ``torch.profiler`` trace of the forward."""
    from bench_port import gen, tracing
    from bench_port.reference.layers import tf32
    from bench_port.reference.nets import swin_t as ref_net
    from sykepic_tpu_torch.models import checkpoint, registry

    cfg = {"image_shape": [3, 180, 180], "head": [256, 128],
           "num_classes": 50, "logit_std": 8.0, "calibration_rois": 64}
    params = gen.make_weights(ref_net, cfg, 2**31 + 23, cuda,
                              gen.fixture_images())
    model = registry.build_model("swin_t", 50)
    model.load_state_dict(checkpoint.normalize_state_dict(
        {k: v.cpu() for k, v in params.items()}, "swin_t"), strict=True)
    model = model.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.rand(64, 3, 180, 180, generator=torch.Generator().manual_seed(3))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    with tf32(False), torch.inference_mode():
        want = ref_net.forward(params, x, cfg)
        n0 = layernorm.launches
        got = model(x)
        assert layernorm.launches - n0 == 29
        with tracing.DeviceTrace() as tr:
            model(x[:8])
    gap = float((got - want).abs().max()) / float(want.std())
    print(f"swin_t logits: max gap {gap:.3g} of the spread")
    assert gap <= SWIN_LOGIT_TOL
    attention = {name: n for name, (_, n) in tr.summary["kernels"].items()
                 if any(w in name.lower() for w in SWIN_ATTENTION_WORDS)}
    print(f"swin_t attention kernels: {attention}")
    assert sum(attention.values()) == 12
