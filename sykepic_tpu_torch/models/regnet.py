"""RegNet X and Y, 400MF-32GF, + the MLP head (the port of
``sykepic_tpu/models/regnet.py``), in torchvision's topology and key
layout: ``stem`` (3x3/2 conv, BN, ReLU to 32 channels), ``trunk_output``
with stages ``block{S}`` of blocks ``block{S}-{B}``; then the global mean
and ``head``.

Every block is torchvision's ``ResBottleneckBlock`` with bottleneck
multiplier 1: ``f.a`` 1x1 -> ``f.b`` grouped 3x3 carrying the stride ->
[``f.se``] -> ``f.c`` 1x1 without activation, plus ``proj`` (1x1 conv + BN)
where the shape changes, and ReLU after the sum. The Y variants' squeeze
width is ``round(0.25 * width of the block's INPUT)``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

from torch import nn

from .layers import ConvNormAct, SqueezeExcitation
from .resnet import Backbone, Head

# name -> (per-stage depths, per-stage widths, group width (per stage where
# torchvision clamps one), se_ratio)
REGNET_CFGS = {
    "regnet_x_400mf": ((1, 2, 7, 12), (32, 64, 160, 400), 16, 0.0),
    "regnet_x_800mf": ((1, 3, 7, 5), (64, 128, 288, 672), 16, 0.0),
    "regnet_x_1_6gf": ((2, 4, 10, 2), (72, 168, 408, 912), 24, 0.0),
    "regnet_x_3_2gf": ((2, 6, 15, 2), (96, 192, 432, 1008), 48, 0.0),
    "regnet_x_8gf": ((2, 5, 15, 1), (80, 240, 720, 1920),
                     (80, 120, 120, 120), 0.0),
    "regnet_x_16gf": ((2, 6, 13, 1), (256, 512, 896, 2048), 128, 0.0),
    "regnet_x_32gf": ((2, 7, 13, 1), (336, 672, 1344, 2520), 168, 0.0),
    "regnet_y_400mf": ((1, 3, 6, 6), (48, 104, 208, 440), 8, 0.25),
    "regnet_y_800mf": ((1, 3, 8, 2), (64, 144, 320, 784), 16, 0.25),
    "regnet_y_1_6gf": ((2, 6, 17, 2), (48, 120, 336, 888), 24, 0.25),
    "regnet_y_3_2gf": ((2, 5, 13, 1), (72, 216, 576, 1512), 24, 0.25),
    "regnet_y_8gf": ((2, 4, 10, 1), (224, 448, 896, 2016), 56, 0.25),
    "regnet_y_16gf": ((2, 4, 11, 1), (224, 448, 1232, 3024), 112, 0.25),
    "regnet_y_32gf": ((2, 5, 12, 1), (232, 696, 1392, 3712), 232, 0.25),
}

STEM_WIDTH = 32


class ResBottleneckBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, group_width: int,
                 se_ratio: float):
        super().__init__()
        self.proj = None
        if cin != cout or stride != 1:
            self.proj = ConvNormAct(cin, cout, 1, stride, act=None)
        units = [("a", ConvNormAct(cin, cout, 1)),
                 ("b", ConvNormAct(cout, cout, 3, stride,
                                   groups=cout // group_width))]
        if se_ratio:
            units.append(("se", SqueezeExcitation(
                cout, max(1, int(round(se_ratio * cin))))))
        units.append(("c", ConvNormAct(cout, cout, 1, act=None)))
        self.f = nn.Sequential(OrderedDict(units))
        self.activation = nn.ReLU(inplace=True)

    def forward(self, x):
        shortcut = x if self.proj is None else self.proj(x)
        return self.activation(shortcut + self.f(x))


class RegNet(Backbone):
    def __init__(self, num_classes: int, depths: Sequence[int],
                 widths: Sequence[int], group_width, se_ratio: float = 0.0,
                 head: Sequence[int] = (256, 128), dropout: Sequence = ()):
        super().__init__()
        self.stem = ConvNormAct(3, STEM_WIDTH, 3, 2)
        stages, cin = [], STEM_WIDTH
        for s, (depth, width) in enumerate(zip(depths, widths), start=1):
            gw = (group_width[s - 1] if isinstance(group_width, (tuple, list))
                  else group_width)
            blocks = []
            for b in range(depth):
                blocks.append((f"block{s}-{b}", ResBottleneckBlock(
                    cin, width, 2 if b == 0 else 1, gw, se_ratio)))
                cin = width
            stages.append((f"block{s}", nn.Sequential(OrderedDict(blocks))))
        self.trunk_output = nn.Sequential(OrderedDict(stages))
        self.head = Head(cin, head, num_classes, dropout)

    def embed(self, x):
        return self.trunk_output(self.stem(x)).mean(dim=(2, 3))


def _regnet(name: str, **kw) -> RegNet:
    depths, widths, group_width, se_ratio = REGNET_CFGS[name]
    return RegNet(depths=depths, widths=widths, group_width=group_width,
                  se_ratio=se_ratio, **kw)


def regnet_x_400mf(**kw) -> RegNet:
    return _regnet("regnet_x_400mf", **kw)


def regnet_x_800mf(**kw) -> RegNet:
    return _regnet("regnet_x_800mf", **kw)


def regnet_x_1_6gf(**kw) -> RegNet:
    return _regnet("regnet_x_1_6gf", **kw)


def regnet_x_3_2gf(**kw) -> RegNet:
    return _regnet("regnet_x_3_2gf", **kw)


def regnet_x_8gf(**kw) -> RegNet:
    return _regnet("regnet_x_8gf", **kw)


def regnet_x_16gf(**kw) -> RegNet:
    return _regnet("regnet_x_16gf", **kw)


def regnet_x_32gf(**kw) -> RegNet:
    return _regnet("regnet_x_32gf", **kw)


def regnet_y_400mf(**kw) -> RegNet:
    return _regnet("regnet_y_400mf", **kw)


def regnet_y_800mf(**kw) -> RegNet:
    return _regnet("regnet_y_800mf", **kw)


def regnet_y_1_6gf(**kw) -> RegNet:
    return _regnet("regnet_y_1_6gf", **kw)


def regnet_y_3_2gf(**kw) -> RegNet:
    return _regnet("regnet_y_3_2gf", **kw)


def regnet_y_8gf(**kw) -> RegNet:
    return _regnet("regnet_y_8gf", **kw)


def regnet_y_16gf(**kw) -> RegNet:
    return _regnet("regnet_y_16gf", **kw)


def regnet_y_32gf(**kw) -> RegNet:
    return _regnet("regnet_y_32gf", **kw)
