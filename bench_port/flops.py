"""Operations and bytes of the work, counted from shapes: the yardstick of
the model's share of the card's peak and of K1's share of its roofline.

- :func:`forward_flops`: the FLOPs of one image through a reference network
  (``torch.utils.flop_counter`` over meta tensors: two per multiply-add of
  every convolution and matrix product; BatchNorm, activations and pooling
  are not counted).
- :func:`shipped_pixels`: the pixels the host ships for ROIs of given
  shapes, those larger than the input shrunk first.
- :func:`k1_eval_bytes`: the least traffic of K1's evaluation form for a set
  of ROIs: each ROI's shipped pixels read once, each slot's
  ``target x target x chans`` output written once at its dtype, and the
  slot's metadata (ten int32 words) read once; :func:`k1_train_bytes` adds
  the train form's affine rows and brightness factor.
- :func:`peaks`: the card's published peaks (``peaks.json``), matched by
  the device name.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.preprocess import resize_geometry

META_BYTES_PER_SLOT = 10 * 4
TRAIN_BYTES_PER_SLOT = 5 * 4  # the affine rows and the brightness factor
PEAKS = Path(__file__).resolve().parent / "peaks.json"
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def forward_flops(net, cfg: dict) -> int:
    """FLOPs of one ``cfg["image_shape"]`` image through ``net``."""
    params = {name: torch.empty(shape, device="meta",
                                dtype=torch.int64 if kind == "bn_count"
                                else torch.float32)
              for name, shape, kind, _ in net.param_specs(cfg)}
    x = torch.empty((1, *cfg["image_shape"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        net.forward(params, x, cfg)
    return int(counter.get_total_flops())


def shipped_pixels(shapes, target: int) -> int:
    """Pixels the host ships for ROIs of ``shapes`` (after the shrink of
    those larger than the input)."""
    total = 0
    for h, w in shapes:
        h, w = int(h), int(w)
        if h > target or w > target:
            nh, nw = resize_geometry(h, w, target)
            if nh < h or nw < w:
                h, w = nh, nw
        total += h * w
    return total


def k1_eval_bytes(shipped_pixels: int, n_rois: int, target: int,
                  chans: int, dtype: str) -> int:
    """Least bytes K1's evaluation form moves for ``n_rois`` ROIs whose
    shipped pixels add up to ``shipped_pixels``."""
    out = target * target * chans * DTYPE_BYTES[dtype]
    return shipped_pixels + n_rois * (out + META_BYTES_PER_SLOT)


def k1_train_bytes(shipped_pixels: int, n_images: int, target: int,
                   chans: int, dtype: str) -> int:
    """Least bytes K1's train form moves for ``n_images`` images: those of
    the evaluation form plus each slot's affine rows and brightness."""
    return (k1_eval_bytes(shipped_pixels, n_images, target, chans, dtype)
            + n_images * TRAIN_BYTES_PER_SLOT)


def peaks(device_name: str) -> dict:
    """The entry of ``peaks.json`` whose ``match`` is in ``device_name``."""
    for entry in json.loads(PEAKS.read_text()):
        if entry["match"] in device_name:
            return entry
    raise KeyError(f"no published peaks for {device_name!r} in {PEAKS}")
