"""ConvNeXt tiny/small/base/large + the MLP head (the port of
``sykepic_tpu/models/convnext.py``), in torchvision's topology and key
layout: ``features`` = [stem, stage 1, down 2, stage 2, down 3, stage 3,
down 4, stage 4]; then the global mean and ``head``.

- Stem: 4x4/4 conv (bias) + LayerNorm (eps 1e-6); each downsample is the
  LayerNorm *before* the 2x2/2 conv.
- :class:`CNBlock`: depthwise 7x7 (bias) -> LayerNorm over the channels ->
  Linear 4x -> exact-erf GELU -> Linear -> ``layer_scale`` -> row-mode
  stochastic depth at ``sd_prob * block / (blocks - 1)`` -> residual add.
- No LayerNorm before the head: torchvision keeps its final norm in
  ``classifier``, which the reference's ``children[:-1]`` drops.

The engine and the trainer hold activations in channels_last, so every
LayerNorm normalises the channel axis of an NHWC view
(:class:`LayerNorm2d`), never the last axis of the NCHW view.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .layers import check_min_input
from .resnet import Backbone, Head, StochasticDepth

# name -> (dims per stage, blocks per stage, stochastic depth prob)
CONVNEXT_CFGS: dict[str, tuple] = {
    "convnext_tiny": ((96, 192, 384, 768), (3, 3, 9, 3), 0.1),
    "convnext_small": ((96, 192, 384, 768), (3, 3, 27, 3), 0.4),
    "convnext_base": ((128, 256, 512, 1024), (3, 3, 27, 3), 0.5),
    "convnext_large": ((192, 384, 768, 1536), (3, 3, 27, 3), 0.5),
}

LN_EPS = 1e-6
LAYER_SCALE_INIT = 1e-6


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channel axis of an NCHW tensor (torchvision
    ``LayerNorm2d``)."""

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.permute(0, 3, 1, 2)


class Permute(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute(*self.dims)


class CNBlock(nn.Module):
    def __init__(self, dim: int, sd_prob: float):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute((0, 2, 3, 1)),
            nn.LayerNorm(dim, eps=LN_EPS),
            nn.Linear(dim, 4 * dim),
            nn.GELU(),  # the exact erf form
            nn.Linear(4 * dim, dim),
            Permute((0, 3, 1, 2)),
        )
        self.layer_scale = nn.Parameter(
            torch.full((dim, 1, 1), LAYER_SCALE_INIT))
        self.stochastic_depth = StochasticDepth(sd_prob)

    def forward(self, x):
        return x + self.stochastic_depth(self.layer_scale * self.block(x))


class ConvNeXt(Backbone):
    # below 32 px a downsample conv runs on a 1x1 map and empties it
    MIN_INPUT = 32

    def __init__(self, dims: Sequence[int], blocks: Sequence[int],
                 sd_prob: float, num_classes: int,
                 head: Sequence[int] = (256, 128), dropout: Sequence = ()):
        super().__init__()
        layers = [nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4),
                                LayerNorm2d(dims[0], eps=LN_EPS))]
        total, block_id = sum(blocks), 0
        for i, (dim, n) in enumerate(zip(dims, blocks)):
            if i > 0:
                layers.append(nn.Sequential(
                    LayerNorm2d(dims[i - 1], eps=LN_EPS),
                    nn.Conv2d(dims[i - 1], dim, 2, stride=2)))
            stage = []
            for _ in range(n):
                stage.append(CNBlock(dim, sd_prob * block_id
                                     / max(total - 1, 1)))
                block_id += 1
            layers.append(nn.Sequential(*stage))
        self.features = nn.Sequential(*layers)
        self.head = Head(dims[-1], head, num_classes, dropout)

    def embed(self, x):
        check_min_input(x, "convnext", self.MIN_INPUT,
                        "the stem and downsample strides empty the feature "
                        "map below that")
        return self.features(x).mean(dim=(2, 3))


def _convnext(name: str, **kw) -> ConvNeXt:
    dims, blocks, sd = CONVNEXT_CFGS[name]
    return ConvNeXt(dims, blocks, sd, **kw)


def convnext_tiny(**kw) -> ConvNeXt:
    return _convnext("convnext_tiny", **kw)


def convnext_small(**kw) -> ConvNeXt:
    return _convnext("convnext_small", **kw)


def convnext_base(**kw) -> ConvNeXt:
    return _convnext("convnext_base", **kw)


def convnext_large(**kw) -> ConvNeXt:
    return _convnext("convnext_large", **kw)
