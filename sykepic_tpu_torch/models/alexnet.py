"""AlexNet + the MLP head (the port of ``sykepic_tpu/models/alexnet.py``),
in torchvision's topology and key layout: ``features`` = Conv 11x11/4 pad
2, ReLU, MaxPool 3x3/2, Conv 5x5 pad 2, ReLU, MaxPool, three Conv 3x3 pad 1
with ReLU, MaxPool (every conv with its bias); then
``AdaptiveAvgPool2d((6, 6))`` (a 180x180 input reaches it at 4x4, where
the windows overlap), the flatten in NCHW order and ``head``.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn
from torch.nn import functional as F

from .layers import check_min_input
from .resnet import Backbone, Head


class AlexNet(Backbone):
    # below 63 px the third 3x3/2 max pool runs on a 1x1 map and empties it
    MIN_INPUT = 63

    def __init__(self, num_classes: int, head: Sequence[int] = (256, 128),
                 dropout: Sequence = ()):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
        )
        self.head = Head(256 * 6 * 6, head, num_classes, dropout)

    def embed(self, x):
        check_min_input(x, "alexnet", self.MIN_INPUT,
                        "the pooling stack empties the feature map below "
                        "that, where torch itself errors")
        return F.adaptive_avg_pool2d(self.features(x), (6, 6)).flatten(1)


def alexnet(**kw) -> AlexNet:
    return AlexNet(**kw)
