"""Plain class probabilities of ROIs: preprocessing, the network in float32
and the temperature softmax.

The logits are multiplied by ``ln(1.3)`` before the softmax (the
reference sykepic's temperature, ``probability.py:18,191-194``), and the
softmax is taken in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .layers import tf32
from .preprocess import preprocess

TEMPERATURE = math.log(1.3)
BLOCK = 256  # ROIs a forward pass, so that the reference fits beside others


def probabilities(images, params: dict, net, cfg: dict, device,
                  allow_tf32: bool = False) -> np.ndarray:
    """``(len(images), classes)`` float64 probabilities. ``allow_tf32``
    computes the network's convolutions and products in TF32 (the control
    of one precision below float32)."""
    _, _, size = cfg["image_shape"]
    chans = cfg["image_shape"][0]
    out = []
    with tf32(allow_tf32), torch.no_grad():
        for s in range(0, len(images), BLOCK):
            x = preprocess(images[s:s + BLOCK], size, chans, device)
            logits = net.forward(params, x, cfg).double()
            out.append(torch.softmax(logits * TEMPERATURE, dim=-1).cpu())
    if not out:
        return np.zeros((0, cfg["num_classes"]))
    return torch.cat(out).numpy()


def as_written(p: np.ndarray) -> np.ndarray:
    """Probabilities as a ``.prob.csv`` holds them: five decimals, half to
    even."""
    return np.rint(np.asarray(p, np.float64) * 1e5) / 1e5
