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

The trainer holds activations in channels_last, and so does the engine
for ConvNeXt at every dtype (it finds :class:`LayerNorm2d` and
:class:`Permute` in the model; other float32 networks run in NCHW there),
so every LayerNorm normalises the channel axis of an NHWC view
(:class:`LayerNorm2d`), never the last axis of the NCHW view, and each
permute is a free view.

In an eval forward on the card (:func:`~.layers.eval_kernel_runs`:
float32, channels_last, autocast off, no gradient recorded) each LayerNorm
is the hand-written kernel of :mod:`sykepic_tpu_torch.ops.layernorm`, and
each block's depthwise 7x7 that of :mod:`sykepic_tpu_torch.ops.depthwise`,
one launch a call each. Where a convolution comes straight before the
LayerNorm (the stem, and each block's depthwise 7x7) the convolution runs
without its bias and the LayerNorm kernel adds it (``pre_bias``).
Everywhere else (training, bf16, autocast, the CPU, a tensor-parallel
block) ATen's LayerNorm and cuDNN's convolution run as before. The
modules, parameters and state-dict keys are the same on both paths.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import depthwise, layernorm
from .layers import check_min_input, eval_kernel_runs
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


def _conv_no_bias(conv: nn.Conv2d, x):
    """``conv`` of ``x`` without its bias, in NHWC: the depthwise kernel
    where it takes ``conv`` (each block's 7x7), else cuDNN's channels_last
    output as a free view (a copy only where it gave none)."""
    if depthwise.takes(conv):
        return depthwise.depthwise(x.permute(0, 2, 3, 1), conv.weight,
                                   conv.stride[0])
    return conv._conv_forward(x, conv.weight, None).permute(
        0, 2, 3, 1).contiguous()


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channel axis of an NCHW tensor (torchvision
    ``LayerNorm2d``)."""

    def forward(self, x):
        if eval_kernel_runs(x, self):
            return layernorm.layernorm(x.permute(0, 2, 3, 1), self.weight,
                                       self.bias, self.eps).permute(0, 3, 1, 2)
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.permute(0, 3, 1, 2)


class Stem(nn.Sequential):
    """The 4x4/4 convolution and its :class:`LayerNorm2d`; on the eval
    kernel's path the LayerNorm adds the convolution's bias."""

    def forward(self, x):
        conv, norm = self
        if type(conv) is not nn.Conv2d or not eval_kernel_runs(x, self):
            return super().forward(x)
        return layernorm.layernorm(_conv_no_bias(conv, x), norm.weight,
                                   norm.bias, norm.eps,
                                   pre_bias=conv.bias).permute(0, 3, 1, 2)


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
        conv, _, norm, fc1, act, fc2, _ = self.block
        # a tensor-parallel depthwise convolution gathers its channels
        # itself: it keeps ATen's path
        if type(conv) is nn.Conv2d and eval_kernel_runs(x, self):
            h = layernorm.layernorm(_conv_no_bias(conv, x), norm.weight,
                                    norm.bias, norm.eps, pre_bias=conv.bias)
            # one statement a layer, as nn.Sequential runs them: each
            # input is freed as soon as its layer has run
            for layer in (fc1, act, fc2):
                h = layer(h)
            h = h.permute(0, 3, 1, 2)
        else:
            h = self.block(x)
        return x + self.stochastic_depth(self.layer_scale * h)


class ConvNeXt(Backbone):
    # below 32 px a downsample conv runs on a 1x1 map and empties it
    MIN_INPUT = 32

    def __init__(self, dims: Sequence[int], blocks: Sequence[int],
                 sd_prob: float, num_classes: int,
                 head: Sequence[int] = (256, 128), dropout: Sequence = ()):
        super().__init__()
        layers = [Stem(nn.Conv2d(3, dims[0], 4, stride=4),
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

    def eval_memory_format(self, dtype) -> torch.memory_format:
        """channels_last whatever the dtype: the blocks compute in NHWC
        (:class:`LayerNorm2d`, :class:`Permute`), whose permutes are free
        views only under channels_last."""
        return torch.channels_last

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
