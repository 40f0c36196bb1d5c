"""MobileNetV3 large/small + the MLP head (the port of
``sykepic_tpu/models/mobilenet.py``), in torchvision's topology and key
layout: ``features.0`` the stem, ``features.I`` inverted-residual block
``I`` (units in ``.block``: [expand] depthwise [squeeze-excitation]
project), the last ``features`` entry the 1x1 widening to 6x the final
width; then the global mean and ``head``. The reference's head attaches at
the pooled backbone features (960 large / 576 small): torchvision's
classifier is dropped.

Hard-swish or ReLU per block, hard-sigmoid gates of
``make_divisible(expanded // 4)`` channels, ``(k - 1) // 2`` padding, and
BatchNorm eps 1e-3 with Flax momentum 0.99 (torchvision's 0.01).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

from torch import nn

from .layers import ConvNormAct, SqueezeExcitation
from .resnet import Backbone, BatchNorm2d, Head


def make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision ``_make_divisible``: the nearest multiple of 8, never
    below 90% of ``v``."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (kernel, expanded_ch, out_ch, use_se, use_hs, stride) per block
V3_LARGE_CONFIG = (
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
)
V3_SMALL_CONFIG = (
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
)

_norm = partial(BatchNorm2d, momentum=0.99, eps=1e-3)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, exp: int, kernel: int,
                 stride: int, use_se: bool, use_hs: bool):
        super().__init__()
        act = nn.Hardswish if use_hs else nn.ReLU
        layers = []
        if exp != cin:
            layers.append(ConvNormAct(cin, exp, 1, act=act, norm=_norm))
        layers.append(ConvNormAct(exp, exp, kernel, stride, groups=exp,
                                  act=act, norm=_norm))
        if use_se:
            layers.append(SqueezeExcitation(exp, make_divisible(exp // 4),
                                            act=nn.ReLU, gate=nn.Hardsigmoid))
        layers.append(ConvNormAct(exp, cout, 1, act=None, norm=_norm))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.block(x)
        return y + x if self.residual else y


class MobileNetV3(Backbone):
    def __init__(self, num_classes: int, config: Sequence = V3_LARGE_CONFIG,
                 stem_ch: int = 16, head: Sequence[int] = (256, 128),
                 dropout: Sequence = ()):
        super().__init__()
        layers = [ConvNormAct(3, stem_ch, 3, 2, act=nn.Hardswish,
                              norm=_norm)]
        cin = stem_ch
        for k, exp, out, se, hs, stride in config:
            layers.append(InvertedResidual(cin, out, exp, k, stride, se, hs))
            cin = out
        layers.append(ConvNormAct(cin, 6 * cin, 1, act=nn.Hardswish,
                                  norm=_norm))
        self.features = nn.Sequential(*layers)
        self.head = Head(6 * cin, head, num_classes, dropout)

    def embed(self, x):
        return self.features(x).mean(dim=(2, 3))


def mobilenet_v3_large(**kw) -> MobileNetV3:
    return MobileNetV3(config=V3_LARGE_CONFIG, **kw)


def mobilenet_v3_small(**kw) -> MobileNetV3:
    return MobileNetV3(config=V3_SMALL_CONFIG, **kw)
