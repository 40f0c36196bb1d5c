"""EfficientNet B0-B7 and V2 S/M/L + the MLP head (the port of
``sykepic_tpu/models/efficientnet.py``), in torchvision's topology and key
layout: ``features.0`` the stem, ``features.G.R`` repeat ``R`` of stage
``G`` (an :class:`MBConv` or :class:`FusedMBConv` whose units sit in
``.block``), the last ``features`` entry the 1x1 head convolution; then the
global mean and ``head``.

As in the JAX package: SiLU, squeeze-excitation of ``max(1, in // 4)``
channels on every MBConv, symmetric ``k // 2`` padding, the expanded width
``in * expand`` (no rounding to 8), BatchNorm eps 1e-5 (V1) or 1e-3 (V2),
and no stochastic depth (torchvision has it; the JAX package does not).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

from torch import nn

from .layers import ConvNormAct, SqueezeExcitation
from .resnet import Backbone, BatchNorm2d, Head

# (expand_ratio, channels, repeats, stride, kernel)  -- EfficientNet-B0
B0_CONFIG = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# V2: (kind, expand, channels, repeats, stride, kernel); "fused" is
# FusedMBConv, "mb" MBConv (torchvision ``_efficientnet_conf``)
V2_S_CONFIG = (
    ("fused", 1, 24, 2, 1, 3),
    ("fused", 4, 48, 4, 2, 3),
    ("fused", 4, 64, 4, 2, 3),
    ("mb", 4, 128, 6, 2, 3),
    ("mb", 6, 160, 9, 1, 3),
    ("mb", 6, 256, 15, 2, 3),
)
V2_M_CONFIG = (
    ("fused", 1, 24, 3, 1, 3),
    ("fused", 4, 48, 5, 2, 3),
    ("fused", 4, 80, 5, 2, 3),
    ("mb", 4, 160, 7, 2, 3),
    ("mb", 6, 176, 14, 1, 3),
    ("mb", 6, 304, 18, 2, 3),
    ("mb", 6, 512, 5, 1, 3),
)
V2_L_CONFIG = (
    ("fused", 1, 32, 4, 1, 3),
    ("fused", 4, 64, 7, 2, 3),
    ("fused", 4, 96, 7, 2, 3),
    ("mb", 4, 192, 10, 2, 3),
    ("mb", 6, 224, 19, 1, 3),
    ("mb", 6, 384, 25, 2, 3),
    ("mb", 6, 640, 7, 1, 3),
)


class MBConv(nn.Module):
    """[expand 1x1] -> depthwise kxk -> squeeze-excitation -> project 1x1
    (no activation), residual when the shape holds."""

    def __init__(self, cin: int, cout: int, expand: int, stride: int,
                 kernel: int, norm):
        super().__init__()
        mid = cin * expand
        layers = []
        if expand != 1:
            layers.append(ConvNormAct(cin, mid, 1, act=nn.SiLU, norm=norm))
        layers += [
            ConvNormAct(mid, mid, kernel, stride, groups=mid, act=nn.SiLU,
                        norm=norm),
            SqueezeExcitation(mid, max(1, cin // 4), act=nn.SiLU),
            ConvNormAct(mid, cout, 1, act=None, norm=norm),
        ]
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.block(x)
        return y + x if self.residual else y


class FusedMBConv(nn.Module):
    """EfficientNetV2's fused block: one dense kxk convolution (to
    ``in * expand``, then a 1x1 projection without activation; straight to
    ``cout`` when ``expand`` is 1), no squeeze-excitation."""

    def __init__(self, cin: int, cout: int, expand: int, stride: int,
                 kernel: int, norm):
        super().__init__()
        if expand != 1:
            mid = cin * expand
            layers = [ConvNormAct(cin, mid, kernel, stride, act=nn.SiLU,
                                  norm=norm),
                      ConvNormAct(mid, cout, 1, act=None, norm=norm)]
        else:
            layers = [ConvNormAct(cin, cout, kernel, stride, act=nn.SiLU,
                                  norm=norm)]
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.block(x)
        return y + x if self.residual else y


class EfficientNet(Backbone):
    """EfficientNet backbone + the shared MLP :class:`Head`. ``config`` rows
    are V1 5-tuples (always MBConv) or V2 6-tuples with a leading kind;
    ``bn_eps`` applies to every BatchNorm."""

    def __init__(self, num_classes: int, config: Sequence = B0_CONFIG,
                 stem_ch: int = 32, head_ch: int = 1280,
                 head: Sequence[int] = (256, 128), dropout: Sequence = (),
                 bn_eps: float = 1e-5):
        super().__init__()
        norm = partial(BatchNorm2d, eps=bn_eps)
        stages = [ConvNormAct(3, stem_ch, 3, 2, act=nn.SiLU, norm=norm)]
        cin = stem_ch
        for entry in config:
            kind, expand, cout, repeats, stride, kernel = (
                entry if len(entry) == 6 else ("mb", *entry))
            block = FusedMBConv if kind == "fused" else MBConv
            stages.append(nn.Sequential(*(
                block(cin if r == 0 else cout, cout, expand,
                      stride if r == 0 else 1, kernel, norm)
                for r in range(repeats))))
            cin = cout
        stages.append(ConvNormAct(cin, head_ch, 1, act=nn.SiLU, norm=norm))
        self.features = nn.Sequential(*stages)
        self.head = Head(head_ch, head, num_classes, dropout)

    def embed(self, x):
        return self.features(x).mean(dim=(2, 3))


def efficientnet_b0(**kw) -> EfficientNet:
    return EfficientNet(**kw)


def _round_filters(channels: float, width: float) -> int:
    """Compound-scaling channel rounding: a multiple of 8, never below 90%
    of the scaled width."""
    channels *= width
    new = max(8, (int(channels + 4) // 8) * 8)
    if new < 0.9 * channels:
        new += 8
    return int(new)


def _scaled(width: float, depth: float, **kw) -> EfficientNet:
    config = tuple((e, _round_filters(c, width), int(math.ceil(r * depth)),
                    s, k) for e, c, r, s, k in B0_CONFIG)
    return EfficientNet(config=config, stem_ch=_round_filters(32, width),
                        head_ch=_round_filters(1280, width), **kw)


def efficientnet_b1(**kw) -> EfficientNet:
    return _scaled(1.0, 1.1, **kw)


def efficientnet_b2(**kw) -> EfficientNet:
    return _scaled(1.1, 1.2, **kw)


def efficientnet_b3(**kw) -> EfficientNet:
    return _scaled(1.2, 1.4, **kw)


def efficientnet_b4(**kw) -> EfficientNet:
    return _scaled(1.4, 1.8, **kw)


def efficientnet_b5(**kw) -> EfficientNet:
    return _scaled(1.6, 2.2, **kw)


def efficientnet_b6(**kw) -> EfficientNet:
    return _scaled(1.8, 2.6, **kw)


def efficientnet_b7(**kw) -> EfficientNet:
    return _scaled(2.0, 3.1, **kw)


def _v2(config, **kw) -> EfficientNet:
    # the stem is the first stage's width; every V2 widens to 1280 and
    # takes BatchNorm eps 1e-3
    return EfficientNet(config=config, stem_ch=config[0][2], head_ch=1280,
                        bn_eps=1e-3, **kw)


def efficientnet_v2_s(**kw) -> EfficientNet:
    return _v2(V2_S_CONFIG, **kw)


def efficientnet_v2_m(**kw) -> EfficientNet:
    return _v2(V2_M_CONFIG, **kw)


def efficientnet_v2_l(**kw) -> EfficientNet:
    return _v2(V2_L_CONFIG, **kw)
