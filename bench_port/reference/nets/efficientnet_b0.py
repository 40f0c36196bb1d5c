"""Plain EfficientNet-B0 (Tan and Le, arXiv:1905.11946; torchvision's
layout) with the stacked-linear head of the configuration.

Stem conv 3x3/2 (32) -> BatchNorm -> SiLU; seven stages of MBConv blocks
``(expand, channels, repeats, stride, kernel)``: an expanding 1x1
convolution when ``expand`` > 1, a depthwise ``kernel`` convolution with the
stage's stride on the first repeat, squeeze-excitation to ``max(1, cin //
4)`` channels (SiLU, sigmoid gate), a projecting 1x1 convolution without
activation, and the residual where shape holds; 1x1 convolution to 1280 ->
BatchNorm -> SiLU -> global mean -> ``head`` linears. Padding is symmetric
``kernel // 2``, BatchNorm eps 1e-5, no stochastic depth (evaluation).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..layers import bn, bn_spec, conv, conv_spec, head, head_spec

STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
          (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
          (6, 320, 1, 1, 3))
STEM, TOP = 32, 1280


def _blocks():
    """``(name, cin, cout, expand, stride, kernel)`` per MBConv."""
    cin = STEM
    for g, (expand, cout, repeats, stride, kernel) in enumerate(STAGES):
        for r in range(repeats):
            yield (f"features.{g + 1}.{r}", cin, cout, expand,
                   stride if r == 0 else 1, kernel)
            cin = cout


def _units(name, cin, expand):
    """Unit names of one block: ``(expand or None, dw, se, project)``."""
    base = f"{name}.block"
    i = 0 if expand == 1 else 1
    return ((None if expand == 1 else f"{base}.0"), f"{base}.{i}",
            f"{base}.{i + 1}", f"{base}.{i + 2}")


def _widths(cfg) -> list:
    return [TOP, *cfg["head"], cfg["num_classes"]]


def param_specs(cfg) -> list:
    specs = conv_spec("features.0.0", STEM, cfg["image_shape"][0], 3)
    specs += bn_spec("features.0.1", STEM)
    for name, cin, cout, expand, _, k in _blocks():
        mid, sq = cin * expand, max(1, cin // 4)
        ex, dw, se, pj = _units(name, cin, expand)
        if ex:
            specs += conv_spec(f"{ex}.0", mid, cin, 1)
            specs += bn_spec(f"{ex}.1", mid)
        specs += conv_spec(f"{dw}.0", mid, mid, k, groups=mid)
        specs += bn_spec(f"{dw}.1", mid)
        specs += conv_spec(f"{se}.fc1", sq, mid, 1, bias=True)
        specs += conv_spec(f"{se}.fc2", mid, sq, 1, bias=True)
        specs += conv_spec(f"{pj}.0", cout, mid, 1)
        specs += bn_spec(f"{pj}.1", cout)
    top = f"features.{len(STAGES) + 1}"
    specs += conv_spec(f"{top}.0", TOP, STAGES[-1][1], 1)
    specs += bn_spec(f"{top}.1", TOP)
    return specs + head_spec(_widths(cfg))


def top_stage(name: str) -> bool:
    """Whether parameter ``name`` is of the last stage or the 1x1 head
    convolution (the training's learning-rate group 1)."""
    return name.startswith((f"features.{len(STAGES)}.",
                            f"features.{len(STAGES) + 1}."))


def last_head_weight(cfg) -> str:
    return f"head.{len(_widths(cfg)) - 2}.weight"


def forward(p: dict, x, cfg):
    """NCHW float32 images -> logits."""
    x = F.silu(bn(p, "features.0.1", conv(p, "features.0.0", x, 2)))
    for name, cin, cout, expand, stride, _ in _blocks():
        ex, dw, se, pj = _units(name, cin, expand)
        y = x
        if ex:
            y = F.silu(bn(p, f"{ex}.1", conv(p, f"{ex}.0", y)))
        y = F.silu(bn(p, f"{dw}.1", conv(p, f"{dw}.0", y, stride,
                                          groups=cin * expand)))
        s = y.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(conv(p, f"{se}.fc2", F.silu(conv(p, f"{se}.fc1",
                                                           s))))
        y = bn(p, f"{pj}.1", conv(p, f"{pj}.0", y * s))
        x = y + x if stride == 1 and cin == cout else y
    top = f"features.{len(STAGES) + 1}"
    x = F.silu(bn(p, f"{top}.1", conv(p, f"{top}.0", x)))
    return head(p, x.mean(dim=(2, 3)), len(_widths(cfg)) - 1)
