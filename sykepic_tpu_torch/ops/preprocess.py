"""Batched eval preprocessing: resize + pad-to-square + scale, in torch.

The port of ``sykepic_tpu/ops/preprocess.py``. A batch of ragged ROIs —
each in its own canvas slot, or many per shelf window at a per-slot origin
(:mod:`sykepic_tpu_torch.ingest.shelf`) — becomes one NHWC float tensor:

1. per-image border value (mode pixel / white / black), host metadata,
2. aspect-preserving bilinear resize to the per-image ``(new_h, new_w)``
   (OpenCV INTER_LINEAR coordinate mapping),
3. constant-border pad to the square target,
4. ``/ 255`` and replication to ``num_chans`` (ImageNet normalization is
   never applied at eval: the reference trains with it and infers without).

On a CUDA tensor :func:`eval_preprocess` launches the hand-written kernel
(:mod:`sykepic_tpu_torch.ops.resize_pad`, ``csrc/resize_pad.cu``); on a CPU
tensor it runs :func:`resize_pad_batch`, the plain twin with the same
arithmetic, which is what the tests hold against the JAX package.

Geometry subtlety: the reference computes ``new_h = int(h * (T / float(w)))``
in float64; 1-ulp differences flip the result (``11 * (180 / 33.0)`` is
59.99999999999999, truncating to 59). :func:`compute_geometry` replicates
that truncation on the host and the device only ever receives the integers.
"""

from __future__ import annotations

import numpy as np
import torch

from . import augment

# ImageNet statistics of torchvision's Normalize (reference config.py:55-56);
# only the TRAIN path applies them
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Rows of the (10, R) int32 slot-metadata pack that the engine uploads and
# the kernel reads: window (or canvas) index, origin, ROI extent, resize
# geometry, border fill.
META_ROWS = ("win_idx", "y0", "x0", "heights", "widths", "new_h", "new_w",
             "pad_top", "pad_left", "border")

# Slots per pass of the plain twin: its gathers materialize (slots, T, T)
# index tensors, so large dispatches go through in bounded pieces.
_TWIN_SLOTS = 256


def compute_geometry(heights, widths, target_h: int, target_w: int):
    """Per-image resize geometry, bit-compatible with reference
    ``image.py:183-198`` (float64 multiply then truncation) and the pad split
    of ``image.py:209-215`` (top/left get ``pad // 2``).

    Parameters are 1-D integer arrays; returns int32 arrays
    ``(new_h, new_w, pad_top, pad_left)``.
    """
    h = np.asarray(heights, dtype=np.float64)
    w = np.asarray(widths, dtype=np.float64)
    taller = h > w
    # h > w: new_h = target_h, new_w = int(w * (target_h / h))
    r_tall = target_h / h
    r_wide = target_w / w
    new_h = np.where(taller, target_h, np.trunc(h * r_wide)).astype(np.int32)
    new_w = np.where(taller, np.trunc(w * r_tall), target_w).astype(np.int32)
    new_h = np.maximum(new_h, 1)
    new_w = np.maximum(new_w, 1)
    pad_h = np.maximum(target_h - new_h, 0)
    pad_w = np.maximum(target_w - new_w, 0)
    pad_top = (pad_h // 2).astype(np.int32)
    pad_left = (pad_w // 2).astype(np.int32)
    return new_h, new_w, pad_top, pad_left


def mode_pixel_batch(canvas, heights, widths) -> np.ndarray:
    """Per-image mode pixel over the valid (h, w) region of a packed canvas
    (host, NumPy). Padding is excluded so zero-fill doesn't skew bin 0:
    one flat bincount over (image_index * 256 + pixel) keys."""
    canvas = np.asarray(canvas)
    b, ch, cw = canvas.shape
    valid = (np.arange(ch)[None, :, None] < np.asarray(heights)[:, None, None]) & (
        np.arange(cw)[None, None, :] < np.asarray(widths)[:, None, None]
    )
    keys = (
        np.arange(b, dtype=np.int64)[:, None, None] * 256 + canvas
    )[valid]
    hist = np.bincount(keys, minlength=b * 256).reshape(b, 256)
    return hist.argmax(axis=1).astype(np.uint8)


def border_values(canvas, heights, widths, border_mode: str) -> np.ndarray:
    """Per-image border fill values for a packed batch (host metadata).

    ``mode``/``white``/``black`` per reference ``image.py:20-23,26-28``.
    """
    n = np.asarray(canvas).shape[0]
    if border_mode == "mode":
        return mode_pixel_batch(canvas, heights, widths)
    if border_mode == "white":
        return np.full(n, 255, np.uint8)
    if border_mode == "black":
        return np.zeros(n, np.uint8)
    raise ValueError(f"Unknown border mode: {border_mode}")


def _axis_taps(size_out: int, pad, n_new, src, q=None):
    """Per slot and output coordinate along one axis: the two source taps
    ``(i0, i1)`` (ROI-local, clamped to ``[0, src - 1]``), their weights
    and the inside flag.

    ``q`` is the ``(R, size_out)`` float32 output coordinate: the iota, or
    ``a * i + b`` when the train form folds an augmentation affine in. The
    coordinate is ``(q - pad + 0.5) * (src / n_new) - 0.5`` in float32,
    clamped to ``[0, src - 1]``, exactly as the JAX einsum builds it; the
    weights are that einsum's ``max(0, 1 - |f - t|)`` at ``t = floor(f)``
    and ``floor(f) + 1``, the second one zero when it falls past the ROI.
    ``inside`` compares the float ``q`` with ``pad`` and ``pad + n_new``
    (``sykepic_tpu/ops/preprocess.py:260-270``), so a flipped or zoomed axis
    keeps its border. The CUDA kernel repeats these float steps one by one,
    in this order.
    """
    if q is None:
        q = torch.arange(size_out, dtype=torch.float32,
                         device=pad.device)[None, :]
    padf = pad.to(torch.float32)[:, None]
    srcf = src.to(torch.float32)[:, None]
    ratio = srcf / n_new.to(torch.float32)[:, None]
    f = (q - padf + 0.5) * ratio - 0.5
    f = torch.minimum(torch.clamp(f, min=0.0), srcf - 1.0)
    t0 = torch.floor(f)
    t1 = t0 + 1.0
    w0 = 1.0 - (f - t0)
    w1 = torch.where(t1 < srcf, 1.0 - (t1 - f), torch.zeros_like(f))
    i0 = t0.to(torch.int64)
    i1 = torch.minimum(i0 + 1, src.to(torch.int64)[:, None] - 1)
    inside = (q >= padf) & (q < padf + n_new.to(torch.float32)[:, None])
    return i0, i1, w0, w1, inside


def _affine_coords(size_out: int, a, b):
    """``(R, size_out)`` float32 ``a * i + b``: a multiply, then an add."""
    i = torch.arange(size_out, dtype=torch.float32, device=a.device)
    return a.to(torch.float32)[:, None] * i[None, :] + b.to(
        torch.float32)[:, None]


def _resize_pad_slots(flat, plane, width, win_idx, y0, x0, heights, widths,
                      new_h, new_w, pad_top, pad_left, border,
                      target_h: int, target_w: int, affine=None):
    """One bounded piece of :func:`resize_pad_batch` (all 1-D args (R,);
    ``affine`` (4, R) or None)."""
    qy = qx = None
    if affine is not None:
        qy = _affine_coords(target_h, affine[0], affine[1])
        qx = _affine_coords(target_w, affine[2], affine[3])
    yi0, yi1, wy0, wy1, in_y = _axis_taps(target_h, pad_top, new_h, heights,
                                          qy)
    xi0, xi1, wx0, wx1, in_x = _axis_taps(target_w, pad_left, new_w, widths,
                                          qx)
    base = (win_idx.to(torch.int64) * plane)[:, None, None]
    rows0 = ((y0.to(torch.int64)[:, None] + yi0) * width)[:, :, None]
    rows1 = ((y0.to(torch.int64)[:, None] + yi1) * width)[:, :, None]
    cols0 = (x0.to(torch.int64)[:, None] + xi0)[:, None, :]
    cols1 = (x0.to(torch.int64)[:, None] + xi1)[:, None, :]

    def tap(rows, cols):
        return flat[base + rows + cols].to(torch.float32)

    wy0 = wy0[:, :, None]
    wy1 = wy1[:, :, None]
    # vertical blend at both source columns first, then horizontal: the
    # order of the einsum's two contractions
    left = wy0 * tap(rows0, cols0) + wy1 * tap(rows1, cols0)
    right = wy0 * tap(rows0, cols1) + wy1 * tap(rows1, cols1)
    val = wx0[:, None, :] * left + wx1[:, None, :] * right
    inside = in_y[:, :, None] & in_x[:, None, :]
    fill = border.to(torch.float32)[:, None, None].expand_as(val)
    return torch.where(inside, val, fill)


def _on(a, device) -> torch.Tensor:
    """Tensor (or array) ``a`` as a tensor on ``device`` (None: as is)."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t if device is None else t.to(device)


def resize_pad_batch(canvas, heights, widths, new_h, new_w, pad_top,
                     pad_left, border, target_h: int, target_w: int,
                     y_origin=None, x_origin=None, win_idx=None, affine=None):
    """Plain twin of the resize/pad kernel: ``(R, target_h, target_w)``
    float32 on the 0-255 scale (the contract of the JAX
    ``resize_pad_batch_mxu``, ``affine_y``/``affine_x`` included).

    Slot ``r`` reads its ``(heights[r], widths[r])`` ROI at rows/cols
    ``[y_origin[r], ...)``, ``[x_origin[r], ...)`` of
    ``canvas[win_idx[r]]`` (defaults: slot ``r`` of the canvas, origin 0),
    resizes it bilinearly to ``(new_h[r], new_w[r])`` and places it at
    ``(pad_top[r], pad_left[r])`` in a square filled with ``border[r]``.
    Taps are clamped to the ROI's own extent, so neither canvas padding nor
    a shelf neighbour ever leaks in. ``affine`` (float32 ``(4, R)``, rows
    ``a_y, b_y, a_x, b_x``) samples output row/column ``i`` at ``a * i + b``
    instead of ``i``. All per-slot args are 1-D tensors (or arrays) on any
    device; the work runs on ``canvas``'s device.
    """
    canvas = _on(canvas, None)
    dev = canvas.device
    n_win, hc, wc = canvas.shape
    args = [_on(a, dev) for a in (heights, widths, new_h, new_w, pad_top,
                                  pad_left, border)]
    r = len(args[0])
    zeros = torch.zeros(r, dtype=torch.int64, device=dev)
    win_idx = (torch.arange(r, device=dev) if win_idx is None
               else _on(win_idx, dev))
    y0 = zeros if y_origin is None else _on(y_origin, dev)
    x0 = zeros if x_origin is None else _on(x_origin, dev)
    affine = None if affine is None else _on(affine, dev)
    flat = canvas.reshape(-1)
    out = torch.empty((r, target_h, target_w), dtype=torch.float32,
                      device=dev)
    for s in range(0, r, _TWIN_SLOTS):
        sl = slice(s, s + _TWIN_SLOTS)
        out[sl] = _resize_pad_slots(
            flat, hc * wc, wc, win_idx[sl], y0[sl], x0[sl],
            *(a[sl] for a in args), target_h, target_w,
            affine=None if affine is None else affine[:, sl])
    return out


def resize_pad_plain(pixels, meta, target_h: int, target_w: int,
                     num_chans: int, dtype=torch.float32, affine=None,
                     bright=None, mean=None, std=None, raw: bool = False):
    """The plain version of the kernel's whole contract: uint8 ``pixels``
    ``(N, H, W)`` and the ``(10, R)`` slot metadata (:data:`META_ROWS`) ->
    ``(R, target_h, target_w, num_chans)`` NHWC in ``dtype``, divided by
    255. Used by the kernel's wrapper for CPU tensors and held against the
    kernel on the card.

    The train form, in the JAX train step's order
    (``sykepic_tpu/train/trainer.py:171-207``): ``affine`` (float32
    ``(4, R)``) folds flip/translate/zoom into the sampling coordinate;
    ``bright`` (float32 ``(R,)``) is ``apply_brightness``'s multiply, clip
    and floor; then ``/ 255``, the channel copy, and ``(x - mean) / std``
    per channel when ``mean``/``std`` (float32 ``(num_chans,)``) are
    given. ``raw`` keeps the 0-255 scale (no division)."""
    win_idx, y0, x0, h, w, nh, nw, pt, pl, border = meta
    img = resize_pad_batch(pixels, h, w, nh, nw, pt, pl, border,
                           target_h, target_w, y_origin=y0, x_origin=x0,
                           win_idx=win_idx, affine=affine)
    if bright is not None:
        img = augment.apply_brightness(img, bright.to(img.device))
    return to_channels(img, num_chans, dtype, mean, std, divide=not raw)


def to_channels(img, num_chans: int, dtype=torch.float32, mean=None,
                std=None, divide: bool = True):
    """A ``(R, H, W)`` float32 batch on the 0-255 scale -> ``(R, H, W,
    num_chans)`` in ``dtype``: ``/ 255`` (unless ``divide`` is off), the
    channel copy, then ``(x - mean) / std`` per channel when given (the
    tail of the JAX train step, ``sykepic_tpu/train/trainer.py:197-207``)."""
    if divide:
        # a true division, as the JAX package and the kernel do: torch
        # turns a division by a Python or 0-d scalar into a multiply by its
        # reciprocal, which differs in the last ulp, so the divisor is a
        # 1-element tensor
        img = img / torch.full((1,), 255.0, device=img.device)
    img = img[..., None].expand(-1, -1, -1, num_chans)
    if mean is not None:
        img = (img - mean.to(img.device)) / std.to(img.device)
    return img.to(dtype).contiguous()


def slot_meta(heights, widths, new_h, new_w, pad_top, pad_left, border,
              win_idx=None, y_origin=None, x_origin=None) -> np.ndarray:
    """Pack per-slot host arrays into the ``(10, R)`` int32 metadata array
    (slot path defaults: slot ``r`` reads canvas ``r`` at origin 0)."""
    r = len(heights)
    zeros = np.zeros(r, np.int32)
    return np.stack([
        np.arange(r, dtype=np.int32) if win_idx is None else win_idx,
        zeros if y_origin is None else y_origin,
        zeros if x_origin is None else x_origin,
        heights, widths, new_h, new_w, pad_top, pad_left, border,
    ]).astype(np.int32)


def eval_preprocess_meta(pixels: torch.Tensor, meta: torch.Tensor, *,
                         target_h: int, target_w: int, num_chans: int = 3,
                         dtype=torch.float32) -> torch.Tensor:
    """Eval preprocessing from the packed metadata: uint8 ``pixels`` and
    ``(10, R)`` int32 ``meta`` on one device -> ``(R, T_h, T_w, C)`` NHWC.
    On a CUDA tensor this launches the resize/pad kernel."""
    from . import resize_pad

    return resize_pad.resize_pad(pixels, meta, target_h, target_w,
                                 num_chans, dtype)


def eval_preprocess(canvas, heights, widths, new_h, new_w, pad_top,
                    pad_left, border, *, target_h: int, target_w: int,
                    num_chans: int = 3, dtype=torch.float32, y_origin=None,
                    x_origin=None, win_idx=None) -> torch.Tensor:
    """Fused eval-path preprocessing (reference eval transform = Resize +
    ToTensor; the reference normalizes with ImageNet statistics only in its
    TRAIN transform, so inference never does).

    Same arguments as the JAX ``eval_preprocess`` plus ``win_idx`` (shelf
    windows are read in place, without a per-slot copy). Returns
    ``(B, target_h, target_w, num_chans)`` NHWC in ``dtype`` — the JAX
    package's layout; ``.permute(0, 3, 1, 2)`` is a channels_last NCHW view.
    """
    canvas = _on(canvas, None)
    meta = slot_meta(*(None if a is None else _on(a, "cpu").numpy()
                       for a in (heights, widths, new_h, new_w, pad_top,
                                 pad_left, border, win_idx, y_origin,
                                 x_origin)))
    return eval_preprocess_meta(
        canvas, torch.from_numpy(meta).to(canvas.device),
        target_h=target_h, target_w=target_w, num_chans=num_chans,
        dtype=dtype)
