"""Plain evaluation preprocessing of one ROI batch: the host pre-shrink,
the border value, the aspect-preserving bilinear resize, the pad to the
square input, ``/ 255`` and the channel copy.

The arithmetic is the contract the port's resize/pad kernel keeps
(OpenCV's INTER_LINEAR coordinate mapping, the reference's float64
truncation of the resize geometry, the pad split ``pad // 2``), written
out here on its own:

- A ROI larger than the input on either side is first shrunk on the host
  to its resize geometry with OpenCV's uint8 INTER_LINEAR (11-bit
  fixed-point taps), as the port ships it.
- The border is the ROI's most common pixel value (the lowest on a tie),
  of the ROI as shipped.
- Output pixel ``q`` of an axis samples the ROI at ``f = (q - pad + 0.5)
  * (src / new) - 0.5``, clamped to ``[0, src - 1]``, blending taps
  ``floor(f)`` and ``floor(f) + 1`` with weights ``1 - |f - t|`` (the
  second zero past the ROI); rows are blended first, then columns, in
  float32. Pixels outside ``[pad, pad + new)`` take the border.
- Training: the output coordinate ``q`` is an affine map of the index
  (flip, translate and zoom folded in), and brightness multiplies, clips
  and floors before ``/ 255``.
"""

from __future__ import annotations

import numpy as np
import torch


def resize_geometry(h: int, w: int, target: int) -> tuple[int, int]:
    """``(new_h, new_w)``: the longer side to ``target``, the other scaled
    by ``target / longer`` in float64 and truncated (at least 1)."""
    if h > w:
        return target, max(1, int(w * (target / h)))
    return max(1, int(h * (target / w))), target


def _linear_taps(src: int, dst: int):
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    low = s < 0
    s[low], f[low] = 0, 0
    high = s >= src - 1
    s[high], f[high] = src - 1, 0
    c1 = np.rint(f * np.float32(2048)).astype(np.int64)
    c0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), c0, c1


def shrink_linear_u8(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """OpenCV's uint8 INTER_LINEAR resize: the horizontal pass with 11-bit
    weights in integers, then the vertical pass rounded as its vector path
    rounds, ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2 >> 2``."""
    h, w = img.shape
    sx0, sx1, cx0, cx1 = _linear_taps(w, new_w)
    sy0, sy1, cy0, cy1 = _linear_taps(h, new_h)
    src = img.astype(np.int64)
    rows = src[:, sx0] * cx0 + src[:, sx1] * cx1
    r0, r1 = rows[sy0] >> 4, rows[sy1] >> 4
    out = (((r0 * cy0[:, None]) >> 16) + ((r1 * cy1[:, None]) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def as_shipped(img: np.ndarray, target: int) -> np.ndarray:
    """The ROI as the host ships it: shrunk when it is larger than the
    input and its geometry is smaller on some side."""
    h, w = img.shape
    if h <= target and w <= target:
        return img
    nh, nw = resize_geometry(h, w, target)
    if nh >= h and nw >= w:
        return img
    return shrink_linear_u8(img, nh, nw)


def _axis(size: int, pad, new, src, q=None):
    """Taps along one axis; ``q`` the ``(B, size)`` float32 output
    coordinates (default: the output index itself)."""
    if q is None:
        q = torch.arange(size, dtype=torch.float32,
                         device=pad.device)[None, :]
    padf, srcf = pad.float()[:, None], src.float()[:, None]
    f = (q - padf + 0.5) * (srcf / new.float()[:, None]) - 0.5
    f = torch.minimum(torch.clamp(f, min=0.0), srcf - 1.0)
    t0 = torch.floor(f)
    w0 = 1.0 - (f - t0)
    w1 = torch.where(t0 + 1.0 < srcf, 1.0 - (t0 + 1.0 - f),
                     torch.zeros_like(f))
    i0 = t0.long()
    i1 = torch.minimum(i0 + 1, src.long()[:, None] - 1)
    inside = (q >= padf) & (q < padf + new.float()[:, None])
    return i0, i1, w0, w1, inside


def preprocess(images, target: int, chans: int, device, affine=None,
               bright=None) -> torch.Tensor:
    """uint8 ROIs (any sizes) -> ``(B, chans, target, target)`` float32 on
    ``device``. The training form: ``affine`` ``(4, B)`` float32 rows
    ``a_y, b_y, a_x, b_x`` sample output row or column ``i`` at ``a * i +
    b`` (a multiply, then an add); ``bright`` ``(B,)`` multiplies the
    resized image, then clips to [0, 255] and floors."""
    shipped = [as_shipped(np.asarray(im), target) for im in images]
    n = len(shipped)
    hs = np.array([im.shape[0] for im in shipped])
    ws = np.array([im.shape[1] for im in shipped])
    canvas = np.zeros((n, hs.max(), ws.max()), np.uint8)
    border = np.zeros(n, np.float32)
    geom = np.zeros((n, 2), np.int64)
    for i, im in enumerate(shipped):
        canvas[i, :im.shape[0], :im.shape[1]] = im
        border[i] = np.bincount(im.reshape(-1), minlength=256).argmax()
        geom[i] = resize_geometry(im.shape[0], im.shape[1], target)
    c = torch.from_numpy(canvas).to(device)
    h = torch.from_numpy(hs).to(device)
    w = torch.from_numpy(ws).to(device)
    nh = torch.from_numpy(geom[:, 0]).to(device)
    nw = torch.from_numpy(geom[:, 1]).to(device)
    qy = qx = None
    if affine is not None:
        i = torch.arange(target, dtype=torch.float32, device=device)
        qy = affine[0][:, None] * i[None, :] + affine[1][:, None]
        qx = affine[2][:, None] * i[None, :] + affine[3][:, None]
    yi0, yi1, wy0, wy1, iny = _axis(target, (target - nh) // 2, nh, h, qy)
    xi0, xi1, wx0, wx1, inx = _axis(target, (target - nw) // 2, nw, w, qx)
    b = torch.arange(n, device=device)[:, None, None]

    def tap(rows, cols):
        return c[b, rows[:, :, None], cols[:, None, :]].float()

    left = wy0[:, :, None] * tap(yi0, xi0) + wy1[:, :, None] * tap(yi1, xi0)
    right = wy0[:, :, None] * tap(yi0, xi1) + wy1[:, :, None] * tap(yi1, xi1)
    val = wx0[:, None, :] * left + wx1[:, None, :] * right
    fill = torch.from_numpy(border).to(device)[:, None, None].expand_as(val)
    img = torch.where(iny[:, :, None] & inx[:, None, :], val, fill)
    if bright is not None:
        img = torch.floor(torch.clamp(img * bright[:, None, None], 0.0, 255.0))
    img = img / torch.full((1,), 255.0, device=device)
    return img[:, None].expand(-1, chans, -1, -1).contiguous()
