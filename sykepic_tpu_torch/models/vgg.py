"""VGG 11/13/16/19, with and without BatchNorm, + the MLP head (the port
of ``sykepic_tpu/models/vgg.py``), in torchvision's topology and key
layout: ``features`` the Sequential of Conv (bias on, in the ``_bn``
variants too), [BatchNorm], ReLU and 2x2/2 MaxPool; then
``AdaptiveAvgPool2d((7, 7))``, the flatten in NCHW order and ``head``.

``F.adaptive_avg_pool2d`` is torch's own definition of the adaptive
windows ``[floor(i * in / out), ceil((i + 1) * in / out))``, which the JAX
package repeats; a 180x180 input reaches the pool at 5x5, where the
windows overlap.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn
from torch.nn import functional as F

from .layers import check_min_input
from .resnet import Backbone, BatchNorm2d, Head

# conv widths per stage; "M" = the 2x2/2 max pool closing the stage
VGG_CFGS: dict[str, tuple] = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M",
              512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M",
              512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(Backbone):
    # below 32 px the fifth 2x2/2 max pool runs on a 1x1 map and empties it
    MIN_INPUT = 32

    def __init__(self, cfg: Sequence, batch_norm: bool, num_classes: int,
                 head: Sequence[int] = (256, 128), dropout: Sequence = ()):
        super().__init__()
        layers, cin = [], 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers.append(nn.Conv2d(cin, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2d(v))
            layers.append(nn.ReLU(inplace=True))
            cin = v
        self.features = nn.Sequential(*layers)
        self.head = Head(cin * 7 * 7, head, num_classes, dropout)

    def embed(self, x):
        check_min_input(x, "vgg", self.MIN_INPUT,
                        "five 2x2/2 max pools empty the feature map below "
                        "that")
        return F.adaptive_avg_pool2d(self.features(x), (7, 7)).flatten(1)


def vgg11(**kw) -> VGG:
    return VGG(VGG_CFGS["vgg11"], False, **kw)


def vgg11_bn(**kw) -> VGG:
    return VGG(VGG_CFGS["vgg11"], True, **kw)


def vgg13(**kw) -> VGG:
    return VGG(VGG_CFGS["vgg13"], False, **kw)


def vgg13_bn(**kw) -> VGG:
    return VGG(VGG_CFGS["vgg13"], True, **kw)


def vgg16(**kw) -> VGG:
    return VGG(VGG_CFGS["vgg16"], False, **kw)


def vgg16_bn(**kw) -> VGG:
    return VGG(VGG_CFGS["vgg16"], True, **kw)


def vgg19(**kw) -> VGG:
    return VGG(VGG_CFGS["vgg19"], False, **kw)


def vgg19_bn(**kw) -> VGG:
    return VGG(VGG_CFGS["vgg19"], True, **kw)
