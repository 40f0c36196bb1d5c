"""The port's augmentation maps (``sykepic_tpu_torch/ops/augment.py``)
against the JAX package's (``sykepic_tpu/ops/augment.py``): translate
limits equal; ``separable_params`` given JAX's drawn values equals JAX's
``(a, b)`` bit for bit; the port's own draws (a ``torch.Generator``, whose
streams differ from JAX's PRNG) stay in range, translate inclusive at
+-limit and zoom rounded to 2 decimals; ``apply_brightness`` equal.

The rotation route: the port's ``augment_batch`` given JAX's draws
(``_affine_params`` with the same key) against JAX's ``augment_batch`` on
the same 0-255 batch: at most 0.1% of pixels one level apart (float32
``cos``/``sin`` and the blend may differ by an ulp before the floor), the
rest within 1e-3; the inverse map itself within 1e-3 px."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sykepic_tpu.ops import augment as jax_augment
from sykepic_tpu_torch.ops import augment


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _limits(rng, b, target=180):
    from sykepic_tpu_torch.ops import preprocess

    h = rng.integers(1, 400, b)
    w = rng.integers(1, 400, b)
    nh, nw, _, _ = preprocess.compute_geometry(h, w, target, target)
    return h, w, nh, nw


def test_translate_limits_equal():
    h, w, nh, nw = _limits(np.random.default_rng(0), 500)
    for got, want in zip(augment.translate_limits(h, w, nh, nw, 180, 180),
                         jax_augment.translate_limits(h, w, nh, nw, 180,
                                                      180)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [
    dict(flip=True, translate=True, zoom=True, brightness=True),
    dict(flip=True, translate=False, zoom=False, brightness=False),
    dict(flip=False, translate=True, zoom=True, brightness=False),
    dict(flip=True, translate=True, zoom=True, brightness=False,
         zoom_range=(0.6, 1.4)),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_separable_params_equal_jax_on_its_draws(flags, seed):
    b, size = 300, 180
    h, w, nh, nw = _limits(np.random.default_rng(seed), b)
    lim_x, lim_y = augment.translate_limits(h, w, nh, nw, size, size)
    kw = dict(zoom_range=flags.get("zoom_range", (0.8, 1.2)),
              brightness_range=(0.95, 1.1))
    on = {k: flags[k] for k in ("flip", "translate", "zoom", "brightness")}
    key = jax.random.PRNGKey(seed)
    flip_h, flip_v, tx, ty, f, _angle, bright = jax_augment._affine_params(
        key, b, rotate=False, max_rotation=0, limit_x=jnp.asarray(lim_x),
        limit_y=jnp.asarray(lim_y), **on, **kw)
    (ay, by), (ax, bx), jb = jax_augment.separable_params(
        key, b, jnp.asarray(lim_x), jnp.asarray(lim_y), size, size, **on,
        **kw)
    draws = augment.Draws(*(torch.from_numpy(np.array(v)) for v in
                            (flip_h, flip_v, tx, ty, f, bright)))
    (pay, pby), (pax, pbx), pb = augment.separable_params(draws, size, size)
    for got, want in ((pay, ay), (pby, by), (pax, ax), (pbx, bx), (pb, jb)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = augment.affine_rows(draws, size, size)
    np.testing.assert_array_equal(rows.numpy(), np.stack(
        [np.asarray(v) for v in (ay, by, ax, bx)]))


def test_draws_stay_in_range():
    b = 20000
    rng = np.random.default_rng(1)
    lim_x = torch.from_numpy(rng.integers(0, 4, b).astype(np.int32))
    lim_y = torch.from_numpy(rng.integers(0, 4, b).astype(np.int32))
    g = torch.Generator().manual_seed(3)
    d = augment.draw_params(g, b, lim_x, lim_y, flip=True, translate=True,
                            zoom=True, brightness=True,
                            zoom_range=(0.6, 1.4),
                            brightness_range=(0.95, 1.1))
    for t in (d.tx, d.ty):
        assert t.dtype == torch.float32
        assert torch.equal(t, torch.round(t))
    assert bool((d.tx.abs() <= lim_x).all() and (d.ty.abs() <= lim_y).all())
    for lim in (1, 2, 3):  # inclusive at both ends
        sel = lim_x == lim
        assert {-lim, lim} <= set(d.tx[sel].int().tolist())
    assert bool(((d.f >= 0.6) & (d.f <= 1.4)).all())
    cents = d.f.double() * 100
    assert float((cents - torch.round(cents)).abs().max()) < 1e-4
    assert {0.6, 1.4} <= {round(v, 2) for v in d.f.tolist()}
    assert bool(((d.bright >= 0.95) & (d.bright <= 1.1)).all())
    assert 0.45 < float(d.flip_h.float().mean()) < 0.55
    assert 0.45 < float(d.flip_v.float().mean()) < 0.55


def test_draws_repeat_for_a_seed_and_off_is_identity():
    lim = torch.full((50,), 3, dtype=torch.int32)

    def draw(seed, **kw):
        return augment.draw_params(torch.Generator().manual_seed(seed), 50,
                                   lim, lim, zoom_range=(0.8, 1.2), **kw)

    a = draw(5, flip=True, translate=True, zoom=True)
    b = draw(5, flip=True, translate=True, zoom=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    off = draw(5)
    assert not off.flip_h.any() and not off.flip_v.any()
    assert float(off.tx.abs().sum() + off.ty.abs().sum()) == 0.0
    assert bool((off.f == 1).all() and (off.bright == 1).all())
    (ay, by), (ax, bx), _ = augment.separable_params(off, 180, 180)
    assert bool((ay == 1).all() and (by == 0).all())


def test_apply_brightness_equal():
    rng = np.random.default_rng(2)
    img = rng.uniform(-5, 260, (6, 20, 30)).astype(np.float32)
    br = rng.uniform(0.9, 1.2, 6).astype(np.float32)
    got = augment.apply_brightness(torch.from_numpy(img), torch.from_numpy(br))
    want = jax_augment.apply_brightness(jnp.asarray(img), jnp.asarray(br))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spec_kwargs_equal():
    args = (("flip", "zoom", "brightness"), (0.6, 1.4), (0.95, 1.1), 10)
    assert augment.spec_kwargs(*args) == jax_augment.spec_kwargs(*args)


def _rotation_case(seed, b=24, h=48, w=40, **flags):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    # smooth content, so the blend weights matter
    imgs = (imgs + np.roll(imgs, 1, 1) + np.roll(imgs, 1, 2)) / 3
    border = rng.integers(0, 256, b).astype(np.uint8)
    lim_x = rng.integers(0, 6, b).astype(np.int32)
    lim_y = rng.integers(0, 6, b).astype(np.int32)
    kw = dict(flip=True, translate=True, zoom=True, rotate=True,
              brightness=True, zoom_range=(0.6, 1.4),
              brightness_range=(0.9, 1.2), max_rotation=30)
    kw.update(flags)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment.augment_batch(
        key, jnp.asarray(imgs), jnp.asarray(border), jnp.asarray(lim_x),
        jnp.asarray(lim_y), **kw))
    fh, fv, tx, ty, f, angle, bright = jax_augment._affine_params(
        key, b, limit_x=jnp.asarray(lim_x), limit_y=jnp.asarray(lim_y),
        **kw)
    draws = augment.Draws(*(torch.from_numpy(np.array(v)) for v in
                            (fh, fv, tx, ty, f, bright, angle)))
    return imgs, border, draws, want, (fh, fv, tx, ty, f, angle)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("flags", [{}, dict(zoom=False, brightness=False),
                                   dict(flip=False, translate=False)])
def test_rotation_warp_matches_jax_on_its_draws(seed, flags):
    imgs, border, draws, want, _ = _rotation_case(seed, **flags)
    got = augment.augment_batch(torch.from_numpy(imgs), draws,
                                torch.from_numpy(border)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    levels = np.abs(got - want)
    far = levels > 1e-3
    assert far.mean() <= 1e-3, far.mean()
    assert levels[far].max(initial=0.0) <= 1.0 + 1e-3
    assert bool((draws.angle != 0).any())
    # the border shows where the chain moves content out of the frame
    assert (want == np.floor(np.clip(border[:, None, None] * np.asarray(
        draws.bright)[:, None, None], 0, 255))).any()


def test_inverse_map_matches_jax():
    imgs, _, draws, _, (fh, fv, tx, ty, f, angle) = _rotation_case(4)
    h, w = imgs.shape[1:]
    sx, sy = augment.compose_inverse(draws, h, w)
    oy = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    ox = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    for i in range(imgs.shape[0]):
        inv = jax_augment._compose_inverse(fh[i], fv[i], tx[i], ty[i], f[i],
                                           angle[i], h, w)
        wx, wy = inv(ox, oy)
        np.testing.assert_allclose(sx[i].numpy(), np.asarray(wx), rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(sy[i].numpy(), np.asarray(wy), rtol=0,
                                   atol=1e-3)


def test_rotation_draws_are_integer_degrees_in_range():
    lim = torch.zeros(20000, dtype=torch.int32)
    d = augment.draw_params(torch.Generator().manual_seed(2), 20000, lim,
                            lim, rotate=True, max_rotation=10)
    assert d.angle.dtype == torch.float32
    assert torch.equal(d.angle, torch.round(d.angle))
    assert set(d.angle.int().tolist()) == set(range(-10, 11))
    off = augment.draw_params(torch.Generator().manual_seed(2), 5, lim[:5],
                              lim[:5])
    assert float(off.angle.abs().sum()) == 0.0
