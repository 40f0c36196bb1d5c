"""Plain ConvNeXt-T (Liu et al., "A ConvNet for the 2020s",
arXiv:2201.03545; torchvision's ``convnext_tiny`` layout) with the
stacked-linear head of the configuration.

Stem conv 4x4/4 (96, bias) -> LayerNorm over the channels; four stages of
(3, 3, 9, 3) blocks at widths (96, 192, 384, 768), stages 2-4 each led by a
downsample: LayerNorm over the channels -> conv 2x2/2 (bias). A block:
depthwise conv 7x7 (pad 3, bias) -> LayerNorm over the channels -> Linear
to 4x the width -> GELU (the exact erf form) -> Linear back -> times the
per-channel ``layer_scale`` -> added to the block's input. Then the global
mean -> ``head`` linears (no activation between them). LayerNorm eps 1e-6,
no stochastic depth (evaluation).

Departures from the published network:

- no LayerNorm before the head: torchvision keeps its final norm in
  ``classifier``, which the reference syke-pic drops with the rest of
  ``classifier`` (``children[:-1]``) before it adds its own head;
- each LayerNorm normalises the last axis of an NHWC view (a permute of
  the NCHW tensor), as torchvision's ``LayerNorm2d`` and ``CNBlock`` do.
"""

from __future__ import annotations

from torch.nn import functional as F

from ..layers import conv_spec, head, head_spec

DIMS = (96, 192, 384, 768)
DEPTHS = (3, 3, 9, 3)
LN_EPS = 1e-6


def _blocks():
    """``(name, dim)`` per block, in order."""
    for i, (dim, depth) in enumerate(zip(DIMS, DEPTHS)):
        for j in range(depth):
            yield f"features.{2 * i + 1}.{j}", dim


def _ln_spec(name: str, c: int) -> list:
    # LayerNorm's scale and shift drawn as BatchNorm's are (1 + 0.1 n and
    # 0.05 n); LayerNorm keeps no running statistics
    return [(f"{name}.weight", (c,), "bn_weight", None),
            (f"{name}.bias", (c,), "bn_bias", None)]


def _linear_spec(name: str, cout: int, cin: int) -> list:
    return [(f"{name}.weight", (cout, cin), "linear", cin),
            (f"{name}.bias", (cout,), "linear_bias", None)]


def _widths(cfg) -> list:
    return [DIMS[-1], *cfg["head"], cfg["num_classes"]]


def param_specs(cfg) -> list:
    specs = conv_spec("features.0.0", DIMS[0], cfg["image_shape"][0], 4,
                      bias=True)
    specs += _ln_spec("features.0.1", DIMS[0])
    for i in range(1, len(DIMS)):
        down = f"features.{2 * i}"
        specs += _ln_spec(f"{down}.0", DIMS[i - 1])
        specs += conv_spec(f"{down}.1", DIMS[i], DIMS[i - 1], 2, bias=True)
    for name, dim in _blocks():
        specs += conv_spec(f"{name}.block.0", dim, dim, 7, groups=dim,
                           bias=True)
        specs += _ln_spec(f"{name}.block.2", dim)
        specs += _linear_spec(f"{name}.block.3", 4 * dim, dim)
        specs += _linear_spec(f"{name}.block.5", dim, 4 * dim)
        # order 1 (1 + 0.1 n), not torchvision's 1e-6 init, which would
        # take every block out of the result
        specs.append((f"{name}.layer_scale", (dim, 1, 1), "bn_weight", None))
    return specs + head_spec(_widths(cfg))


def last_head_weight(cfg) -> str:
    return f"head.{len(_widths(cfg)) - 2}.weight"


def layer_norm(p: dict, name: str, x):
    """LayerNorm over the channels of an NCHW tensor, on its NHWC view."""
    y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],),
                     p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)
    return y.permute(0, 3, 1, 2)


def block(p: dict, name: str, x):
    """One ConvNeXt block on NCHW ``x``."""
    b = f"{name}.block"
    y = F.conv2d(x, p[f"{b}.0.weight"], p[f"{b}.0.bias"], padding=3,
                 groups=x.shape[1])
    y = F.layer_norm(y.permute(0, 2, 3, 1), (x.shape[1],), p[f"{b}.2.weight"],
                     p[f"{b}.2.bias"], LN_EPS)
    y = F.linear(y, p[f"{b}.3.weight"], p[f"{b}.3.bias"])
    y = F.gelu(y)
    y = F.linear(y, p[f"{b}.5.weight"], p[f"{b}.5.bias"])
    return x + p[f"{name}.layer_scale"] * y.permute(0, 3, 1, 2)


def forward(p: dict, x, cfg):
    """NCHW float32 images -> logits."""
    x = F.conv2d(x, p["features.0.0.weight"], p["features.0.0.bias"],
                 stride=4)
    x = layer_norm(p, "features.0.1", x)
    for i, depth in enumerate(DEPTHS):
        if i > 0:
            down = f"features.{2 * i}"
            x = layer_norm(p, f"{down}.0", x)
            x = F.conv2d(x, p[f"{down}.1.weight"], p[f"{down}.1.bias"],
                         stride=2)
        for j in range(depth):
            x = block(p, f"features.{2 * i + 1}.{j}", x)
    return head(p, x.mean(dim=(2, 3)), len(_widths(cfg)) - 1)
