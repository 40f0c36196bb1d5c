"""Plain ResNet-18 (He et al., arXiv:1512.03385; torchvision's layout)
with the stacked-linear head of the configuration.

conv 7x7/2 (pad 3) -> BatchNorm -> ReLU -> max-pool 3x3/2 (pad 1) -> four
stages of two basic blocks (64, 128, 256, 512 filters; the first block of
stages 2-4 strides 2 and projects its residual with a 1x1/2 convolution and
BatchNorm) -> global mean -> ``head`` linears (no activation between them).
"""

from __future__ import annotations

from torch.nn import functional as F

from ..layers import bn, bn_spec, conv, conv_spec, head, head_spec

STAGES = (2, 2, 2, 2)
WIDTH = 64


def _blocks():
    """``(name, cin, filters, stride, projects)`` per basic block."""
    cin = WIDTH
    for i, count in enumerate(STAGES):
        filters = WIDTH * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            yield (f"layer{i + 1}.{j}", cin, filters, stride,
                   stride != 1 or cin != filters)
            cin = filters


def _widths(cfg) -> list:
    return [WIDTH * 2 ** (len(STAGES) - 1), *cfg["head"], cfg["num_classes"]]


def param_specs(cfg) -> list:
    specs = conv_spec("conv1", WIDTH, cfg["image_shape"][0], 7)
    specs += bn_spec("bn1", WIDTH)
    for name, cin, f, _, projects in _blocks():
        specs += conv_spec(f"{name}.conv1", f, cin, 3)
        specs += bn_spec(f"{name}.bn1", f)
        specs += conv_spec(f"{name}.conv2", f, f, 3)
        specs += bn_spec(f"{name}.bn2", f)
        if projects:
            specs += conv_spec(f"{name}.downsample.0", f, cin, 1)
            specs += bn_spec(f"{name}.downsample.1", f)
    return specs + head_spec(_widths(cfg))


def top_stage(name: str) -> bool:
    """Whether parameter ``name`` is of the last backbone stage (the
    training's learning-rate group 1)."""
    return name.startswith(f"layer{len(STAGES)}.")


def last_head_weight(cfg) -> str:
    return f"head.{len(_widths(cfg)) - 2}.weight"


def forward(p: dict, x, cfg):
    """NCHW float32 images -> logits."""
    x = F.relu(bn(p, "bn1", conv(p, "conv1", x, 2)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for name, _, _, stride, projects in _blocks():
        res = x
        if projects:
            res = bn(p, f"{name}.downsample.1",
                     conv(p, f"{name}.downsample.0", x, stride))
        y = F.relu(bn(p, f"{name}.bn1", conv(p, f"{name}.conv1", x, stride)))
        y = bn(p, f"{name}.bn2", conv(p, f"{name}.conv2", y))
        x = F.relu(y + res)
    return head(p, x.mean(dim=(2, 3)), len(_widths(cfg)) - 1)
