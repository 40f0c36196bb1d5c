"""K1's train form, plain version (``sykepic_tpu_torch/ops/preprocess.py::
resize_pad_plain`` with ``affine``/``bright``/``mean``/``std``), against
the JAX train step's chain (``sykepic_tpu/train/trainer.py:171-207``):
``resize_pad_batch_mxu(affine_y, affine_x)`` -> ``apply_brightness`` ->
``/ 255`` -> channel copy -> ``(x - mean) / std``, with both flips, zoom
0.6 and 1.4 and translations at -limit and +limit.

Tolerance, on the 0-255 scale: within 1e-3 everywhere, except that with
brightness on a pixel may land one level (1/255) apart, since a 1-ulp
difference in the blended value (the einsum sums its taps in another
order) can move ``v * bright`` across an integer before the floor; those
flips are counted and held to at most 0.1% of pixels. Without an affine the
train form is bit-identical to the eval form (an identity affine gives
the iota exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sykepic_tpu.ops import augment as jax_augment
from sykepic_tpu.ops import preprocess as jax_pre
from sykepic_tpu_torch.ops import augment, preprocess, resize_pad

T = 64  # target side: small, the arithmetic is the same at 180


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, canvas_hw, r=48, n=20):
    """``n`` stored images read by ``r`` slots, their draws and the
    per-slot (gathered) geometry, as both packages take them."""
    rng = np.random.default_rng(seed)
    ch, cw = canvas_hw
    hs = rng.integers(1, ch + 1, n)
    ws = rng.integers(1, cw + 1, n)
    canvas = rng.integers(0, 256, (n, ch, cw), dtype=np.uint8)
    geom = preprocess.compute_geometry(hs, ws, T, T)
    border = rng.integers(0, 256, n).astype(np.uint8)
    rows = rng.integers(0, n, r)
    lim_x, lim_y = augment.translate_limits(hs, ws, geom[0], geom[1], T, T)
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
    meta = preprocess.slot_meta(hs, ws, *geom, border,
                                win_idx=np.arange(n))[:, rows]
    per_slot = dict(canvas=canvas[rows], heights=hs[rows], widths=ws[rows],
                    geom=[g[rows] for g in geom], border=border[rows])
    return canvas, meta, draws, per_slot


def _jax_chain(per_slot, draws, bright, norm):
    (ay, by), (ax, bx), br = augment.separable_params(draws, T, T)
    img = jax_pre.resize_pad_batch_mxu(
        jnp.asarray(per_slot["canvas"]), jnp.asarray(per_slot["heights"]),
        jnp.asarray(per_slot["widths"]),
        *(jnp.asarray(g) for g in per_slot["geom"]),
        jnp.asarray(per_slot["border"]), T, T, dtype=jnp.float32,
        affine_y=(jnp.asarray(ay.numpy()), jnp.asarray(by.numpy())),
        affine_x=(jnp.asarray(ax.numpy()), jnp.asarray(bx.numpy())))
    if bright:
        img = jax_augment.apply_brightness(img, jnp.asarray(br.numpy()))
    img = img / 255.0
    img = jnp.repeat(img[..., None], 3, axis=-1)
    if norm:
        img = (img - jnp.asarray(jax_pre.IMAGENET_MEAN)) / jnp.asarray(
            jax_pre.IMAGENET_STD)
    return np.asarray(img)


@pytest.mark.parametrize("canvas_hw", [(24, 40), (64, 64), (96, 200)])
@pytest.mark.parametrize("bright,norm", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_plain_train_form_matches_the_jax_chain(canvas_hw, bright, norm):
    canvas, meta, draws, per_slot = _inputs(sum(canvas_hw), canvas_hw)
    kw = dict(affine=augment.affine_rows(draws, T, T),
              bright=draws.bright if bright else None)
    if norm:
        kw.update(mean=torch.tensor(preprocess.IMAGENET_MEAN),
                  std=torch.tensor(preprocess.IMAGENET_STD))
    got = resize_pad.resize_pad(torch.from_numpy(canvas),
                                torch.from_numpy(meta), T, T, 3, **kw).numpy()
    want = _jax_chain(per_slot, draws, bright, norm)
    assert got.shape == want.shape == (meta.shape[1], T, T, 3)
    scale = 255.0 * (np.asarray(preprocess.IMAGENET_STD) if norm else 1.0)
    levels = np.abs(got - want) * scale  # on the 0-255 scale
    far = levels > 1e-3
    if bright:
        assert far.mean() <= 1e-3, far.mean()
        assert levels[far].max(initial=0.0) <= 1.0 + 1e-3
    else:
        assert not far.any(), levels.max()
    # every augmentation is in play: flips, both zoom ends, +-limit
    assert draws.flip_h.any() and draws.flip_v.any()
    assert {0.6, 1.4} <= {round(v, 2) for v in draws.f.tolist()}


def test_identity_affine_is_the_eval_form_bit_for_bit():
    canvas, meta, _, _ = _inputs(5, (48, 96))
    r = meta.shape[1]
    ident = torch.stack([torch.ones(r), torch.zeros(r), torch.ones(r),
                         torch.zeros(r)])
    pix, m = torch.from_numpy(canvas), torch.from_numpy(meta)
    eval_form = resize_pad.resize_pad(pix, m, T, T, 3)
    assert torch.equal(resize_pad.resize_pad(pix, m, T, T, 3, affine=ident),
                       eval_form)
    # and that is the JAX eval contract on the slots' own canvases
    want = jax_pre.eval_preprocess(
        jnp.asarray(canvas[meta[0]]),
        *(jnp.asarray(meta[i]) for i in range(3, 10)), target_h=T,
        target_w=T)
    np.testing.assert_allclose(eval_form.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_cpu_wrapper_counts_no_launch_and_writes_out():
    canvas, meta, draws, _ = _inputs(6, (32, 64), r=10)
    before = (resize_pad.launches, resize_pad.train_launches)
    out = torch.zeros((12, T, T, 3))
    got = resize_pad.resize_pad(torch.from_numpy(canvas),
                                torch.from_numpy(meta), T, T, 3,
                                affine=augment.affine_rows(draws, T, T),
                                bright=draws.bright, out=out[1:11])
    assert (resize_pad.launches, resize_pad.train_launches) == before
    assert got.data_ptr() == out[1:11].data_ptr()
    assert float(out[0].abs().sum() + out[11].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="together"):
        resize_pad.resize_pad(torch.from_numpy(canvas),
                              torch.from_numpy(meta), T, T, 3,
                              mean=torch.zeros(3))


@pytest.mark.parametrize("canvas_hw", [(24, 40), (96, 200)])
@pytest.mark.parametrize("norm", [False, True])
def test_rotation_route_matches_the_jax_chain(canvas_hw, norm):
    """The train step's route with ``rotate`` on: K1's eval form on the
    0-255 scale (``raw``), the warp, ``/ 255``, the channel copy and the
    normalisation, against the JAX step's ``resize_pad_batch_mxu`` ->
    ``augment_batch`` -> ``/ 255`` -> repeat -> ``(x - mean) / std`` on the
    same draws: at most 0.1% of pixels one level apart, the rest within
    1e-3 (on the 0-255 scale)."""
    import jax

    canvas, meta, _, per_slot = _inputs(sum(canvas_hw) + 1, canvas_hw)
    r = meta.shape[1]
    lim_x, lim_y = augment.translate_limits(
        per_slot["heights"], per_slot["widths"], *per_slot["geom"][:2], T, T)
    kw = dict(flip=True, translate=True, zoom=True, rotate=True,
              brightness=True, zoom_range=(0.6, 1.4),
              brightness_range=(0.95, 1.1), max_rotation=10)
    key = jax.random.PRNGKey(3)
    img = jax_pre.resize_pad_batch_mxu(
        jnp.asarray(per_slot["canvas"]), jnp.asarray(per_slot["heights"]),
        jnp.asarray(per_slot["widths"]),
        *(jnp.asarray(g) for g in per_slot["geom"]),
        jnp.asarray(per_slot["border"]), T, T, dtype=jnp.float32)
    img = jax_augment.augment_batch(key, img, jnp.asarray(per_slot["border"]),
                                    jnp.asarray(lim_x), jnp.asarray(lim_y),
                                    **kw)
    img = jnp.repeat((img / 255.0)[..., None], 3, axis=-1)
    mean = std = None
    if norm:
        img = (img - jnp.asarray(jax_pre.IMAGENET_MEAN)) / jnp.asarray(
            jax_pre.IMAGENET_STD)
        mean = torch.tensor(preprocess.IMAGENET_MEAN)
        std = torch.tensor(preprocess.IMAGENET_STD)
    want = np.asarray(img)
    fh, fv, tx, ty, f, angle, bright = jax_augment._affine_params(
        key, r, limit_x=jnp.asarray(lim_x), limit_y=jnp.asarray(lim_y), **kw)
    draws = augment.Draws(*(torch.from_numpy(np.array(v)) for v in
                            (fh, fv, tx, ty, f, bright, angle)))
    before = resize_pad.launches
    raw = resize_pad.resize_pad(torch.from_numpy(canvas),
                                torch.from_numpy(meta), T, T, 1, raw=True)
    assert resize_pad.launches == before  # CPU tensors: the plain version
    warped = augment.augment_batch(raw[..., 0], draws,
                                   torch.from_numpy(meta[9]))
    got = preprocess.to_channels(warped, 3, torch.float32, mean, std).numpy()
    assert got.shape == want.shape == (r, T, T, 3)
    scale = 255.0 * (np.asarray(preprocess.IMAGENET_STD) if norm else 1.0)
    levels = np.abs(got - want) * scale
    far = levels > 1e-3
    assert far.mean() <= 1e-3, far.mean()
    assert levels[far].max(initial=0.0) <= 1.0 + 1e-3


def test_raw_form_keeps_the_0_255_scale():
    canvas, meta, _, _ = _inputs(9, (32, 64), r=12)
    pix, m = torch.from_numpy(canvas), torch.from_numpy(meta)
    raw = resize_pad.resize_pad(pix, m, T, T, 1, raw=True)
    scaled = resize_pad.resize_pad(pix, m, T, T, 1)
    assert float(raw.max()) > 1.0
    torch.testing.assert_close(raw / 255.0, scaled, rtol=1e-6, atol=0)
    assert torch.equal(raw[..., 0], preprocess.resize_pad_batch(
        pix, *(m[i] for i in range(3, 10)), T, T, y_origin=m[1],
        x_origin=m[2], win_idx=m[0]))
