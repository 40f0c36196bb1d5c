"""ResNet backbones + configurable MLP head as torch ``nn.Module`` s.

The port of ``sykepic_tpu/models/resnet.py``, which itself rebuilt the
reference's ``TorchVisionNet`` (torchvision resnet minus ``fc`` + stacked
Linear head, ``sykepic/train/network.py:11-72``). Module names follow
torchvision (``conv1``, ``bn1``, ``layerX.Y.{conv1,bn1,...,downsample.0/1}``)
and the reference head (``head.K``), so a reference ``best_state.pth`` loads
with ``strict=True`` once its ``base.N`` prefixes are renamed
(:func:`sykepic_tpu_torch.models.checkpoint.normalize_state_dict`).

- BatchNorm eps 1e-5; inference uses running statistics (``.eval()``).
- Max-pool 3x3 / 2 with padding 1; global average pool.
- The head is literally stacked ``Linear`` layers with no activations in
  between, with Dropout layers spliced in by index using Python
  ``list.insert`` semantics (reference ``network.py:56-63``).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

from torch import nn


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False)


def _bn(c: int):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """ResNet-18/34 basic block (two 3x3 convs)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = _bn(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride),
                                            _bn(filters))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    """ResNet-50/101/152 bottleneck block (1x1 -> 3x3 -> 1x1, expansion 4).

    ``groups`` / ``base_width`` parameterize ResNeXt and Wide-ResNet exactly
    as torchvision does: the inner width is
    ``filters * base_width/64 * groups`` and the 3x3 conv is grouped.
    """

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        cout = filters * self.expansion
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, cout, 1)
        self.bn3 = _bn(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            _bn(cout))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class Head(nn.Sequential):
    """Stacked-Linear classification head with index-spliced Dropout.

    ``sizes`` lists the hidden widths, the final ``num_classes`` layer is
    appended, and each ``(idx, p)`` in ``dropout`` is inserted into the
    layer list with Python ``list.insert`` semantics (negative indices count
    from the end), so Linear ``k`` sits at the reference's ``head.K``.
    """

    def __init__(self, in_features: int, sizes: Sequence[int],
                 num_classes: int, dropout: Sequence[tuple[int, float]] = ()):
        widths = [in_features, *sizes, num_classes]
        layers: list[nn.Module] = [nn.Linear(widths[i], widths[i + 1])
                                   for i in range(len(widths) - 1)]
        for idx, p in dropout:
            layers.insert(int(idx), nn.Dropout(p))
        super().__init__(*layers)


class ResNet(nn.Module):
    """ResNet backbone + MLP head: conv7x7/2 -> bn -> relu -> maxpool3x3/2
    -> 4 stages -> global average pool -> head."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int,
                 head: Sequence[int] = (256, 128),
                 dropout: Sequence[tuple[int, float]] = (),
                 num_filters: int = 64, in_chans: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chans, num_filters, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = _bn(num_filters)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            blocks = []
            filters = num_filters * 2 ** i
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(cin, filters, stride)
                cin = filters * block.expansion
                blocks.append(block)
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.head = Head(cin, head, num_classes, dropout)

    def features(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3))  # global average pool

    def forward(self, x):
        """NCHW (any memory format) -> logits."""
        return self.head(self.features(x))


def resnet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet((3, 8, 36, 3), Bottleneck, **kw)


def _grouped(groups: int, base_width: int):
    return partial(Bottleneck, groups=groups, base_width=base_width)


def resnext50_32x4d(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), _grouped(32, 4), **kw)


def resnext101_32x8d(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), _grouped(32, 8), **kw)


def resnext101_64x4d(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), _grouped(64, 4), **kw)


def wide_resnet50_2(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), _grouped(1, 128), **kw)


def wide_resnet101_2(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), _grouped(1, 128), **kw)
