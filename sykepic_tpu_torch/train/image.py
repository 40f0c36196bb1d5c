"""Dataset image statistics (the port of ``sykepic_tpu/train/image.py``;
reference ``sykepic/train/image.py:229-298``).

The JAX package reads the images with cv2; the port reads PNGs with
:mod:`sykepic_tpu_torch.utils.png` and gives the same numbers:

- ``cv2.imread(path)`` returns three channels in B, G, R order (a gray PNG
  as three equal channels, alpha dropped), so :func:`calculate_mean_std`
  reports its channels in that order;
- ``IMREAD_GRAYSCALE`` is libpng's ``rgb_to_gray``, ``png.to_gray(...,
  gray="imread")``;
- ``cv2.meanStdDev`` is the population statistic of the integer sums, in
  float64: ``mean = s / n``, ``std = sqrt(max(q / n - mean**2, 0))``.

The augmentations that sat beside these in the reference are the device
kernels of :mod:`sykepic_tpu_torch.ops.augment`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ingest import pack
from ..utils import png


def _bgr_or_gray(path, grayscale: bool) -> np.ndarray:
    """``(h, w, c)`` uint8 as ``cv2.imread`` returns it: gray (c = 1) with
    ``IMREAD_GRAYSCALE``, else B, G, R (c = 3)."""
    img = png.decode_png_channels(Path(path).read_bytes(), path)
    if grayscale:
        return png.to_gray(img, gray="imread")[:, :, None]
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return img[:, :, 2::-1]


def _mean_std(img: np.ndarray):
    """``cv2.meanStdDev`` of an ``(h, w, c)`` uint8 image: two ``(c, 1)``
    float64 arrays."""
    n = img.shape[0] * img.shape[1]
    flat = img.reshape(n, -1).astype(np.int64)
    mean = flat.sum(axis=0) / n
    var = (flat * flat).sum(axis=0) / n - mean * mean
    return mean[:, None], np.sqrt(np.maximum(var, 0.0))[:, None]


def calculate_mean_std(img_paths, grayscale: bool = False):
    """Mean and std per channel over a list of images, scaled to [0, 1]
    (reference ``image.py:240-275``: the mean of per-image means and stds);
    shapes ``(3,)`` in B, G, R order, or ``(1,)`` with ``grayscale``. An
    empty list raises ``ZeroDivisionError``, as the JAX package's does."""
    mean_sum = 0.0
    std_sum = 0.0
    img_paths = list(img_paths)
    for path in img_paths:
        mean, std = _mean_std(_bgr_or_gray(path, grayscale))
        mean_sum += mean
        std_sum += std
    mean = np.squeeze(mean_sum / len(img_paths) / 255.0, axis=1)
    std = np.squeeze(std_sum / len(img_paths) / 255.0, axis=1)
    return mean, std


def calculate_mean_dims(img_paths):
    """Truncated mean (height, width) over images (reference ``image.py:
    278-298``), read from each PNG's header. An empty list raises
    ``ValueError("No images given")``."""
    height = 0.0
    width = 0.0
    i = 0
    for i, path in enumerate(img_paths, start=1):
        dims = png.png_dims(path)
        if dims is None:
            raise ValueError(f"{path}: not a readable PNG file")
        height += dims[0]
        width += dims[1]
    if i == 0:
        raise ValueError("No images given")
    return int(height / i), int(width / i)


def mode_pixel_value(img) -> int:
    """Most common pixel value (reference ``image.py:229-237``); the batched
    form is ``ops.preprocess.mode_pixel_batch``."""
    return pack.mode_pixel(img)
