"""Inputs made from the seed: IFCB samples and model weights.

Samples: the ROIs of the fixture sample (``fixture/``, real IFCB textures)
resampled to shapes drawn from IFCB's size mix, written as genuine
``.adc/.roi/.hdr`` triplets. Each sample's ROI count, its multiset of shapes
and its number of empty triggers come from the traffic's ``shape_seed``, so
every run seed does the same work; the run seed orders each sample's ROIs,
places its empty triggers, picks each ROI's source and draws the pixel
noise (a seeded noise tile, of which each ROI takes a patch at a seeded
offset).

Training sets: labelled images in memory, written as grayscale PNGs for
the port's loader.

Weights: every tensor of a reference network's parameter list, drawn on the
device from one ``torch.Generator`` in one normal draw, the BatchNorm
statistics set from a few of the run's own ROIs and the last head layer
scaled so that the logits spread with the configuration's ``logit_std``.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import torch

from .reference import ifcb as ref_ifcb
from .reference.layers import tf32
from .reference.preprocess import preprocess

FIXTURE = Path(__file__).resolve().parent / "fixture" / "D20180712T065600_IFCB114"
ADC_COLUMNS = 24


def fixture_images() -> list[np.ndarray]:
    images = [img for _, img in ref_ifcb.read_sample(FIXTURE)]
    if min(int(i.min()) for i in images) < NOISE or max(
            int(i.max()) for i in images) > 255 - NOISE:
        raise ValueError("fixture levels too close to 0 or 255 for the noise")
    return images


def roi_shapes(rng, n: int, size_mix) -> np.ndarray:
    """``(n, 2)`` int64 ``(h, w)`` drawn from ``size_mix``: rows of
    ``[weight, [h_lo, h_hi], [w_lo, w_hi]]``, bounds inclusive."""
    weights = np.array([m[0] for m in size_mix], np.float64)
    picks = rng.choice(len(size_mix), size=n, p=weights / weights.sum())
    lo = np.array([[m[1][0], m[2][0]] for m in size_mix])[picks]
    hi = np.array([[m[1][1], m[2][1]] for m in size_mix])[picks]
    return rng.integers(lo, hi + 1)


NOISE_TILE = 1024  # side of the noise tile; larger than any ROI of the mix
NOISE = 3  # levels of noise either way


def resampled(src: np.ndarray, h: int, w: int, noise: np.ndarray) -> np.ndarray:
    """``src`` resampled (nearest) to ``(h, w)``, plus ``noise - NOISE``
    (``noise``: an ``(h, w)`` uint8 patch in ``[0, 2 NOISE]``). The fixture's
    levels lie in [34, 240], so uint8 arithmetic neither wraps nor needs a
    clip."""
    ys = np.minimum(np.arange(h) * src.shape[0] // h, src.shape[0] - 1)
    xs = np.minimum(np.arange(w) * src.shape[1] // w, src.shape[1] - 1)
    img = src[np.ix_(ys, xs)]
    img += noise
    img -= NOISE
    return img


def write_sample(path: Path, rows) -> None:
    """One ``.adc/.roi/.hdr`` triplet; ``rows`` holds a uint8 image or None
    (an empty trigger) per ``.adc`` row."""
    lines, payload, start = [], [], 0
    for img in rows:
        cols = ["0"] * ADC_COLUMNS
        h, w = (0, 0) if img is None else img.shape
        cols[ref_ifcb.COL_WIDTH] = str(w)
        cols[ref_ifcb.COL_HEIGHT] = str(h)
        cols[ref_ifcb.COL_START] = str(start)
        lines.append(",".join(cols))
        if img is not None:
            payload.append(img.reshape(-1))
            start += h * w
    _write(path.with_suffix(".adc"), ("\n".join(lines) + "\n").encode())
    _write(path.with_suffix(".roi"), np.concatenate(payload).tobytes())
    _write(path.with_suffix(".hdr"), b"runTime: 1200\ninhibitTime: 18\n")


def _write(path: Path, data: bytes) -> None:
    """Write and flush to the disk, so that the write-back of the pool
    falls in set-up and not in the measured window."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def build_pool(raw_dir: Path, pool: dict, seed: int) -> list[dict]:
    """Write ``pool["samples"]`` samples into ``raw_dir``; returns one
    ``{"path", "shapes"}`` per sample, in the order written (``shapes``:
    ``(n, 2)`` ``(h, w)`` of its ROIs, empty triggers left out)."""
    fixed = np.random.default_rng(pool["shape_seed"])
    lo, hi = pool["rois_per_sample"]
    counts = fixed.integers(lo, hi + 1, pool["samples"])
    shapes = roi_shapes(fixed, int(counts.sum()), pool["size_mix"])
    empties = fixed.binomial(counts, pool["empty_trigger_share"])
    rng = np.random.default_rng(seed)
    images = fixture_images()
    src = rng.integers(len(images), size=len(shapes))
    tile = rng.integers(0, 2 * NOISE + 1, (NOISE_TILE, NOISE_TILE),
                        dtype=np.uint8)
    oy = rng.integers(0, NOISE_TILE - shapes[:, 0] + 1)
    ox = rng.integers(0, NOISE_TILE - shapes[:, 1] + 1)
    start = datetime.fromisoformat(pool["start"])
    raw_dir.mkdir(parents=True, exist_ok=True)
    out, pos = [], 0
    for s, (n, n_empty) in enumerate(zip(counts.tolist(), empties.tolist())):
        order = pos + rng.permutation(n)
        mine = shapes[order]
        rows = [resampled(images[src[k]], h, w,
                          tile[oy[k]:oy[k] + h, ox[k]:ox[k] + w])
                for k, (h, w) in zip(order.tolist(), mine.tolist())]
        pos += n
        for at in np.sort(rng.choice(n + n_empty, n_empty, replace=False)):
            rows.insert(int(at), None)
        when = start + timedelta(minutes=pool["minutes_per_sample"] * s)
        path = raw_dir / f"D{when:%Y%m%dT%H%M%S}_IFCB114"
        write_sample(path, rows)
        out.append({"path": path, "shapes": mine})
    return out


_NORMAL_SCALE = {"conv_bias": 0.01, "linear_bias": 0.01, "bn_bias": 0.05}


def make_weights(net, cfg: dict, seed: int, device, rois) -> dict:
    """``{name: float32 tensor on device}`` for every entry of
    ``net.param_specs(cfg)`` (``(name, shape, kind, fan_in)``): convolutions
    He-normal on their fan-in, linear layers normal with variance ``1 /
    fan_in``, biases of order 0.01, BatchNorm scales ``1 + 0.1 n`` and
    shifts of order 0.05, counters 0. Then, in float32 with TF32 off, on the
    first ``cfg["calibration_rois"]`` of ``rois`` (uint8 images, through the
    reference's preprocessing): the running statistics of every BatchNorm
    are set to those of the batch, so the signal neither dies nor grows
    through the depth, and the last head layer is scaled so that the logits
    spread with the standard deviation ``cfg["logit_std"]``."""
    specs = net.param_specs(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    params, pos = {}, 0
    for size, (name, shape, kind, fan_in) in zip(sizes, specs):
        z = normal[pos:pos + size].view(shape)
        pos += size
        if kind == "conv":
            t = z * math.sqrt(2.0 / fan_in)
        elif kind == "linear":
            t = z / math.sqrt(fan_in)
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * z
        elif kind == "bn_mean":  # set by the calibration below
            t = torch.zeros(shape, device=device)
        elif kind == "bn_var":
            t = torch.ones(shape, device=device)
        elif kind == "bn_count":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            t = _NORMAL_SCALE[kind] * z
        params[name] = t.contiguous()
    chans, size, _ = cfg["image_shape"]
    images = preprocess(rois[:cfg["calibration_rois"]], size, chans, device)
    with tf32(False), torch.no_grad():
        net.forward({**params, "bn": "calibrate"}, images, cfg)
        std = float(net.forward(params, images, cfg).std())
    params[net.last_head_weight(cfg)].mul_(cfg["logit_std"] / std)
    return params


def write_model_dir(path: Path, cfg: dict, params: dict | None) -> Path:
    """A model directory the port loads: ``config.ini`` from ``cfg["ini"]``,
    ``class_names.txt`` and, given ``params``, the weights as
    ``best_state.pth`` in torchvision's key layout."""
    path.mkdir(parents=True, exist_ok=True)
    lines = []
    for section, items in cfg["ini"].items():
        lines.append(f"[{section}]")
        lines += [f"{k} = {v}" for k, v in items.items()]
        lines.append("")
    (path / "config.ini").write_text("\n".join(lines))
    (path / "class_names.txt").write_text("\n".join(cfg["class_names"])
                                          + "\n")
    if params is not None:
        torch.save({k: v.cpu() for k, v in params.items()},
                   path / "best_state.pth")
    return path


def build_train_set(train: dict, seed: int):
    """A labelled training set in memory: ``(images, labels)``. The shapes
    (drawn from ``train["size_mix"]``) and their classes come from
    ``train["shape_seed"]``: ordered by log area plus noise and dealt out
    to the classes in that order, so size follows the class as in plankton
    data. The run seed draws the pixels: gray levels around a class's own
    mean, stripes on every other row for odd classes."""
    fixed = np.random.default_rng(train["shape_seed"])
    n, classes = train["images"], train["classes"]
    shapes = roi_shapes(fixed, n, train["size_mix"])
    key = np.log(shapes[:, 0] * shapes[:, 1]) + fixed.normal(
        0, train["size_noise"], n)
    labels = np.empty(n, np.int64)
    labels[np.argsort(key, kind="stable")] = np.arange(n) * classes // n
    rng = np.random.default_rng(seed)
    images = []
    for (h, w), k in zip(shapes.tolist(), labels.tolist()):
        img = rng.normal(40 + 200 * k / classes, 20, (h, w))
        img[::3] += 30 * (k % 2)
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images, labels


def write_png(path: Path, img: np.ndarray) -> None:
    """``img`` (2-D uint8) as an 8-bit grayscale PNG, every row filter 0."""
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = img

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0,
                                                  0, 0))
                     + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                     + chunk(b"IEND", b""))


def write_train_set(folder: Path, images) -> list[Path]:
    """Each image as ``folder/<index>.png``, flushed to the disk; returns
    the paths in the images' order."""
    folder.mkdir(parents=True, exist_ok=True)
    paths = [folder / f"{i:05}.png" for i in range(len(images))]
    for path, img in zip(paths, images):
        write_png(path, img)
    os.sync()
    return paths
