"""Image statistics the training path reaches (the port of
``sykepic_tpu/train/image.py``; reference ``sykepic/train/image.py``).

Only :func:`mode_pixel_value` is carried: ``calculate_mean_std`` and
``calculate_mean_dims`` are dataset-curation helpers that ``train`` never
calls. The augmentations that sat beside these in the reference are the
device kernels of :mod:`sykepic_tpu_torch.ops.augment`.
"""

from __future__ import annotations

from ..ingest import pack


def mode_pixel_value(img) -> int:
    """Most common pixel value (reference ``image.py:229-237``); the batched
    form is ``ops.preprocess.mode_pixel_batch``."""
    return pack.mode_pixel(img)
