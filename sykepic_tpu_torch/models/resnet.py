"""ResNet backbones + configurable MLP head as torch ``nn.Module`` s.

The port of ``sykepic_tpu/models/resnet.py``, which itself rebuilt the
reference's ``TorchVisionNet`` (torchvision resnet minus ``fc`` + stacked
Linear head, ``sykepic/train/network.py:11-72``). Module names follow
torchvision (``conv1``, ``bn1``, ``layerX.Y.{conv1,bn1,...,downsample.0/1}``)
and the reference head (``head.K``), so a reference ``best_state.pth`` loads
with ``strict=True`` once its ``base.N`` prefixes are renamed
(:func:`sykepic_tpu_torch.models.checkpoint.normalize_state_dict`).

- BatchNorm eps 1e-5; inference uses running statistics (``.eval()``).
  In training the running variance takes the BIASED batch variance, as
  Flax's ``BatchNorm`` does (``nn.BatchNorm2d`` takes the unbiased one):
  :class:`BatchNorm2d`, which the other families share with their own Flax
  momentum and eps.
- Dropout and row-mode stochastic depth in training draw their masks from
  the ``generator`` their owner sets (:class:`Dropout`,
  :class:`StochasticDepth`), so a seeded training run repeats.
- Data parallel training (``sykepic_tpu_torch.parallel``): the trainer
  sets each :class:`BatchNorm2d`'s ``process_group``, so the batch
  statistics are those of the global batch, and each mask draw's
  ``rows``, so every rank draws the global batch's masks and keeps its own
  rows: N ranks then normalise and drop out as one device does.
- Max-pool 3x3 / 2 with padding 1; global average pool.
- The head is literally stacked ``Linear`` layers with no activations in
  between, with Dropout layers spliced in by index using Python
  ``list.insert`` semantics (reference ``network.py:56-63``).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates the running
    statistics as Flax's ``BatchNorm`` does, with Flax's ``momentum`` (0.9
    unless a family says otherwise; MobileNetV3 takes 0.99):
    ``ra_mean = m ra_mean + (1 - m) mean`` and ``ra_var = m ra_var +
    (1 - m) var`` with the biased batch variance. ``nn.BatchNorm2d`` would
    fold in the unbiased one, ``n / (n - 1)`` larger (72/71 at layer4 for a
    batch of 2 at 6x6). The batch statistics come out of the same
    ``F.batch_norm`` call that normalises (into zeroed buffers at momentum
    1, which hold the batch mean and the unbiased variance), so no extra
    pass over the activations is made. Evaluation is ``nn.BatchNorm2d``'s,
    with ``eps``.

    With a ``process_group`` of more than one rank (set by the trainer: its
    mesh's ``data`` group) training takes the statistics of the global
    batch, as GSPMD gives the JAX package: the count and the per-channel sum
    are all-reduced for the mean, then the squared deviations from it for
    the biased variance, so ranks with unequal (even zero) row counts weigh
    right; both reductions are differentiable (:func:`~sykepic_tpu_torch.
    parallel.all_reduce_sum`), and the arithmetic is float32 whatever the
    autocast type. A group of one rank takes the path above, as
    ``torch.nn.SyncBatchNorm`` does: its local batch is the global one."""

    process_group = None

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def _global_forward(self, x):
        from ..parallel import all_reduce_sum

        c = x.shape[1]
        xf = x.float()
        count = torch.full((1,), float(x.numel() // max(c, 1)),
                           device=x.device)
        tot = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), count]),
                             self.process_group)
        n = tot[c]
        mean = tot[:c] / n
        d = xf - mean.view(1, c, 1, 1)
        var = all_reduce_sum((d * d).sum(dim=(0, 2, 3)),
                             self.process_group) / n
        y = (d * torch.rsqrt(var + self.eps).view(1, c, 1, 1)
             * self.weight.view(1, c, 1, 1) + self.bias.view(1, c, 1, 1))
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
        return y.to(x.dtype)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if (self.process_group is not None
                and dist.get_world_size(self.process_group) > 1):
            return self._global_forward(x)
        mean = torch.zeros_like(self.running_mean)
        var_unbiased = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var_unbiased, self.weight, self.bias,
                         training=True, momentum=1.0, eps=self.eps)
        n = x.numel() // x.shape[1]
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_(
                (1.0 - m) * (var_unbiased * ((n - 1) / n)))
        return y


def _draw_rows(module, shape, device):
    """Uniform draws of ``shape`` from ``module.generator``; with
    ``module.rows = (lo, hi, total)`` (set by a data-parallel trainer) the
    draws of the whole ``total``-row batch, of which rows ``[lo, hi)`` are
    this rank's (``shape[0] == hi - lo``), so every rank advances the
    generator alike and N ranks draw what one device draws."""
    rows = module.rows
    if rows is None:
        return torch.rand(shape, generator=module.generator, device=device)
    lo, hi, total = rows
    u = torch.rand((total,) + tuple(shape[1:]), generator=module.generator,
                   device=device)
    return u[lo:hi]


class Dropout(nn.Dropout):
    """``nn.Dropout`` that draws its training mask from ``self.generator``
    (set by the trainer) instead of the global generator: keep with
    probability ``1 - p``, scale the kept values by ``1 / (1 - p)``, as
    Flax's ``Dropout``. ``rows``: see :func:`_draw_rows`."""

    generator: torch.Generator | None = None
    rows: tuple | None = None

    def forward(self, x):
        if not self.training or self.p == 0.0 or self.generator is None:
            return super().forward(x)
        keep = _draw_rows(self, x.shape, x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class StochasticDepth(nn.Module):
    """Row-mode stochastic depth (torchvision ``StochasticDepth(p, "row")``
    and the JAX package's ``CNBlock``): in training each sample's residual
    branch survives with probability ``1 - p`` and survivors are scaled by
    ``1 / (1 - p)``; the draw comes from ``self.generator`` (set by the
    trainer, the global generator without one). The identity in
    evaluation and at ``p = 0``. ``rows``: see :func:`_draw_rows`."""

    generator: torch.Generator | None = None
    rows: tuple | None = None

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = _draw_rows(self, (x.shape[0],) + (1,) * (x.dim() - 1), x.device)
        return x * ((u < keep).to(x.dtype) / keep)


class BasicBlock(nn.Module):
    """ResNet-18/34 basic block (two 3x3 convs)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm2d(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride),
                                            BatchNorm2d(filters))

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
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = _conv(width, cout, 1)
        self.bn3 = BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            BatchNorm2d(cout))

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
            layers.insert(int(idx), Dropout(p))
        super().__init__(*layers)

    def dropout_spec(self) -> list[tuple[int, float]]:
        """The ``(index, p)`` spec that rebuilds this head: each Dropout at
        its final index (inserting them in ascending order puts each back
        there)."""
        return [(i, m.p) for i, m in enumerate(self) if isinstance(m, Dropout)]


class Backbone(nn.Module):
    """The ``base`` + ``head`` contract every family keeps (reference
    ``TorchVisionNet``): :meth:`embed` maps an NCHW batch (any memory
    format) to the pooled, flattened features the :class:`Head` reads."""

    def embed(self, x):
        raise NotImplementedError

    def forward(self, x):
        """NCHW (any memory format) -> logits."""
        return self.head(self.embed(x))

    def eval_memory_format(self, dtype) -> torch.memory_format:
        """The memory format the eval model runs in. Every float32 network
        of dense and grouped convolutions runs in the contiguous NCHW
        format: with TF32 off cuDNN's float32 convolutions are NCHW
        kernels, which a channels_last model wraps in a transpose of their
        input and another of their output. channels_last stays for
        bfloat16, whose tensor-core convolutions are NHWC kernels, and for
        a network with depthwise convolutions, which cuDNN runs as NHWC
        kernels and NCHW hands to ATen's slower depthwise kernels (on an
        H100, an EfficientNet-B0 dispatch of 1,024 slots took 88.8 ms of
        device time in NCHW against 81.3 ms channels_last, transposes
        included). A family whose blocks compute in NHWC overrides this."""
        if dtype == torch.bfloat16 or any(
                isinstance(m, nn.Conv2d) and 1 < m.groups == m.in_channels
                for m in self.modules()):
            return torch.channels_last
        return torch.contiguous_format

    def dispatch_counts(self, height: int, width: int) -> dict[str, int]:
        """The ``StageTimer`` counters one ``height x width`` image adds to
        a dispatch, from the network's own account of its work (none here;
        Swin counts its attention windows)."""
        return {}


class ResNet(Backbone):
    """ResNet backbone + MLP head: conv7x7/2 -> bn -> relu -> maxpool3x3/2
    -> 4 stages -> global average pool -> head."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int,
                 head: Sequence[int] = (256, 128),
                 dropout: Sequence[tuple[int, float]] = (),
                 num_filters: int = 64, in_chans: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chans, num_filters, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm2d(num_filters)
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

    def embed(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3))  # global average pool


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
