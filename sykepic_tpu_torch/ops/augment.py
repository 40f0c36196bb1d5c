"""Training augmentations folded into the resize (the port of
``sykepic_tpu/ops/augment.py``; reference ``sykepic/train/image.py``).

Flip, translate and zoom are axis-separable affine maps, so the JAX package
folds them into its resize: the sampling coordinate of output row or column
``i`` becomes ``q = a * i + b`` per axis (``separable_params``), and
brightness is a multiply, clip and floor after it (``apply_brightness``).
The port does the same inside K1's train form
(:func:`sykepic_tpu_torch.ops.resize_pad.resize_pad` with ``affine`` and
``bright``), one launch per canvas bucket.

The random draws are kept apart from the maps: :func:`draw_params` draws
per-image flips, translations, zoom factors and brightness from an explicit
``torch.Generator`` (whose streams differ from JAX's PRNG), and
:func:`separable_params` turns drawn values into ``(a, b)`` with the JAX
package's float32 steps in its order, so the tests can hand both packages
the same draws.

The rotation warp (``augment_batch``/``_warp_bilinear``) is not ported yet
(ROADMAP Queue 1); a config that asks for ``rotate`` raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Draws(NamedTuple):
    """Per-image augmentation parameters, each ``(B,)``."""

    flip_h: torch.Tensor  # bool
    flip_v: torch.Tensor  # bool
    tx: torch.Tensor  # float32 integers in [-limit_x, limit_x]
    ty: torch.Tensor  # float32 integers in [-limit_y, limit_y]
    f: torch.Tensor  # float32 zoom factor, rounded to 2 decimals
    bright: torch.Tensor  # float32 brightness factor


def translate_limits(heights, widths, new_h, new_w, target_h: int, target_w: int):
    """Per-image translate limits: only the padded axis moves, by
    ``int((target - new) / 2.5)`` (reference ``image.py:39-51``).

    ``heights``/``widths`` are the ORIGINAL image dims (pre-resize); taller
    images pad (and translate) width, wider ones pad height.
    """
    heights = np.asarray(heights)
    widths = np.asarray(widths)
    taller = heights > widths
    lim_x = np.where(taller, ((target_w - np.asarray(new_w)) / 2.5).astype(np.int32), 0)
    lim_y = np.where(~taller, ((target_h - np.asarray(new_h)) / 2.5).astype(np.int32), 0)
    return lim_x.astype(np.int32), lim_y.astype(np.int32)


def _uniform(gen, batch, lo, hi, device):
    u = torch.rand(batch, generator=gen, device=device)
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def _randint_inclusive(gen, limit, device):
    """Integers uniform in ``[-limit, limit]`` per image, as float32 (the
    reference's ``randint(-limit, limit)`` is inclusive at both ends)."""
    span = (2 * limit + 1).to(torch.float32)
    u = torch.rand(limit.shape, generator=gen, device=device)
    k = torch.minimum(torch.floor(u * span), span - 1.0)
    return k - limit.to(torch.float32)


def draw_params(gen: torch.Generator, batch: int, limit_x, limit_y, *,
                flip: bool = False, translate: bool = False,
                zoom: bool = False, brightness: bool = False,
                zoom_range=(1.0, 1.0), brightness_range=(1.0, 1.0),
                device=None) -> Draws:
    """Draw per-image parameters from ``gen`` (the JAX package's
    ``_affine_params`` without rotation). ``limit_x``/``limit_y`` are
    ``(B,)`` integer tensors from :func:`translate_limits`. Disabled
    augmentations draw nothing and give the identity."""
    device = gen.device if device is None else device
    one = torch.ones(batch, dtype=torch.float32, device=device)
    no = torch.zeros(batch, dtype=torch.bool, device=device)
    zero = torch.zeros(batch, dtype=torch.float32, device=device)
    flip_h = flip_v = no
    tx = ty = zero
    f = bright = one
    if flip:
        flip_h = torch.rand(batch, generator=gen, device=device) < 0.5
        flip_v = torch.rand(batch, generator=gen, device=device) < 0.5
    if translate:
        tx = _randint_inclusive(gen, limit_x.to(device), device)
        ty = _randint_inclusive(gen, limit_y.to(device), device)
    if zoom:
        f = _uniform(gen, batch, zoom_range[0], zoom_range[1], device)
        # the reference rounds to 2 decimals (image.py:127); half to even,
        # as jnp.round
        f = torch.round(f * 100.0) / torch.full_like(f, 100.0)
    if brightness:
        bright = _uniform(gen, batch, brightness_range[0],
                          brightness_range[1], device)
    return Draws(flip_h, flip_v, tx, ty, f, bright)


def separable_params(draws: Draws, target_h: int, target_w: int):
    """Per-axis inverse affines ``((a_y, b_y), (a_x, b_x), bright)`` for
    drawn values: the inverse of zoom about the centre then translate,
    flips last, in the JAX package's float32 steps and order
    (``sykepic_tpu/ops/augment.py:199-206``): ``a = 1/f``,
    ``b = c * (1 - 1/f) - t``, then ``a = -a``, ``b = (size - 1) - b`` where
    flipped."""
    f = draws.f.to(torch.float32)
    inv = torch.ones_like(f) / f  # a true division, as jnp's 1.0 / f

    def axis(flipped, t, size):
        c = (size - 1) / 2.0  # a half-integer: exact in float32
        a = inv
        b = c * (1.0 - inv) - t
        a = torch.where(flipped, -a, a)
        b = torch.where(flipped, (size - 1) - b, b)
        return a, b

    return (axis(draws.flip_v, draws.ty, target_h),
            axis(draws.flip_h, draws.tx, target_w), draws.bright)


def affine_rows(draws: Draws, target_h: int, target_w: int) -> torch.Tensor:
    """The ``(4, B)`` float32 ``(a_y, b_y, a_x, b_x)`` rows K1's train form
    reads."""
    (a_y, b_y), (a_x, b_x), _ = separable_params(draws, target_h, target_w)
    return torch.stack([a_y, b_y, a_x, b_x]).to(torch.float32).contiguous()


def apply_brightness(img, bright):
    """Multiplicative brightness + clip + uint8-cast truncation
    (reference ``image.py:174-176``) on a (B, H, W) float batch."""
    return torch.floor(torch.clamp(img * bright[:, None, None], 0.0, 255.0))


def spec_kwargs(augmentations, zoom_range, brightness_range, max_rotation):
    """Static kwargs from an AugmentSpec-style config (reference
    ``train/config.py:32-50``: 'flip' enables both flips; order in the
    config is irrelevant here because the affine composition is fixed)."""
    augs = set(augmentations)
    return dict(
        flip="flip" in augs,
        translate="translate" in augs,
        zoom="zoom" in augs,
        rotate="rotate" in augs,
        brightness="brightness" in augs,
        zoom_range=tuple(zoom_range),
        brightness_range=tuple(brightness_range),
        max_rotation=int(max_rotation),
    )
