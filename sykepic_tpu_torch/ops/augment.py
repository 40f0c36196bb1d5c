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

Rotation is not separable. With ``rotate`` on, the JAX train step resizes
first (K1's eval form, on the 0-255 scale) and then warps the batch:
:func:`augment_batch` composes the inverse of flip -> translate -> zoom ->
rotate per image (:func:`compose_inverse`), samples bilinearly with the
image's constant border (:func:`warp_bilinear`), and applies brightness,
clip and floor. Here that is plain tensor ops, as it was an XLA gather (no
Pallas kernel) in the JAX package, in its float32 steps and order.
"""

from __future__ import annotations

from typing import NamedTuple

import math

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
    # float32 integer degrees in [-max_rotation, max_rotation]; None: 0
    angle: torch.Tensor | None = None


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
                rotate: bool = False, zoom_range=(1.0, 1.0),
                brightness_range=(1.0, 1.0), max_rotation: int = 0,
                device=None) -> Draws:
    """Draw per-image parameters from ``gen`` (the JAX package's
    ``_affine_params``). ``limit_x``/``limit_y`` are ``(B,)`` integer
    tensors from :func:`translate_limits`. Disabled augmentations draw
    nothing and give the identity."""
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
    angle = zero
    if rotate:
        angle = _randint_inclusive(
            gen, torch.full((batch,), int(max_rotation), dtype=torch.int32,
                            device=device), device)
    if brightness:
        bright = _uniform(gen, batch, brightness_range[0],
                          brightness_range[1], device)
    return Draws(flip_h, flip_v, tx, ty, f, bright, angle)


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


def compose_inverse(draws: Draws, h: int, w: int):
    """``(src_x, src_y)``, each ``(B, h, w)`` float32: the source point of
    every output pixel under the inverse of the chain flipH -> flipV ->
    translate -> zoom -> rotate (``sykepic_tpu/ops/augment.py:101-133``).
    Rotation turns by ``-angle`` degrees about the integer centre
    ``(w // 2, h // 2)`` (cv2's); zoom scales by ``1 / f`` about the
    continuous centre ``((w - 1) / 2, (h - 1) / 2)``; the translation
    subtracts; flips mirror last."""
    f = draws.f.to(torch.float32)
    dev = f.device
    angle = (torch.zeros_like(f) if draws.angle is None
             else draws.angle.to(torch.float32))
    # centres are half-integers or integers: exact in float32
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    rcx, rcy = float(w // 2), float(h // 2)
    p_y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    p_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    rad = -angle * torch.tensor(math.pi / 180.0, dtype=torch.float32,
                                device=dev)
    ca = torch.cos(rad)[:, None, None]
    sa = torch.sin(rad)[:, None, None]
    x = p_x - rcx
    y = p_y - rcy
    x, y = ca * x + sa * y, -sa * x + ca * y
    x = x + rcx
    y = y + rcy
    fb = f[:, None, None]
    x = (x - cx) / fb + cx
    y = (y - cy) / fb + cy
    x = x - draws.tx.to(torch.float32)[:, None, None]
    y = y - draws.ty.to(torch.float32)[:, None, None]
    x = torch.where(draws.flip_h[:, None, None], (w - 1) - x, x)
    y = torch.where(draws.flip_v[:, None, None], (h - 1) - y, y)
    return x, y


def warp_bilinear(img, src_x, src_y, border):
    """Bilinear sample of a ``(B, H, W)`` float batch at ``(src_x,
    src_y)`` with the constant ``border`` ``(B,)`` outside the image (cv2
    BORDER_CONSTANT; ``sykepic_tpu/ops/augment.py:136-155``)."""
    b, h, w = img.shape
    inside = (src_x >= 0) & (src_x <= w - 1) & (src_y >= 0) & (src_y <= h - 1)
    fx = torch.clamp(src_x, 0.0, w - 1)
    fy = torch.clamp(src_y, 0.0, h - 1)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = img.reshape(b, h * w)

    def tap(yy, xx):
        return flat.gather(1, (yy * w + xx).reshape(b, -1)).reshape(yy.shape)

    p00, p01 = tap(y0, x0), tap(y0, x1)
    p10, p11 = tap(y1, x0), tap(y1, x1)
    top = p00 + (p01 - p00) * wx
    bot = p10 + (p11 - p10) * wx
    val = top + (bot - top) * wy
    return torch.where(inside, val, border.to(torch.float32)[:, None, None])


def augment_batch(img, draws: Draws, border):
    """The JAX package's ``augment_batch`` on given draws: warp a
    ``(B, H, W)`` float batch on the 0-255 scale by the whole affine chain,
    then brightness, clip and floor; the same shape and scale back."""
    src_x, src_y = compose_inverse(draws, img.shape[1], img.shape[2])
    out = warp_bilinear(img, src_x, src_y, border)
    return apply_brightness(out, draws.bright.to(torch.float32))


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
