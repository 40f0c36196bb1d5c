"""torchvision's building blocks that several families share, with
torchvision's child names, so each family's ``state_dict`` keeps
torchvision's key layout (``features.3.1.block.0.1.running_var``,
``trunk_output.block2.block2-0.f.se.fc1.weight``, ...).

- :class:`ConvNormAct` is ``Conv2dNormActivation``: ``0`` the convolution,
  ``1`` the norm, ``2`` the activation (absent when ``act`` is None).
- :class:`SqueezeExcitation` is ``ops.SqueezeExcitation``: global mean ->
  ``fc1`` 1x1 (bias) -> ``act`` -> ``fc2`` 1x1 (bias) -> ``gate`` -> scale.
- :func:`check_min_input` is the JAX package's small-input ``ValueError``
  of VGG, AlexNet and ConvNeXt.
"""

from __future__ import annotations

from torch import nn

from .resnet import BatchNorm2d


class ConvNormAct(nn.Sequential):
    """Convolution without bias (symmetric ``(k - 1) // 2`` padding),
    norm, optional activation."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, act=nn.ReLU, norm=BatchNorm2d):
        layers = [nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                            groups=groups, bias=False), norm(cout)]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


class SqueezeExcitation(nn.Module):
    """``x * gate(fc2(act(fc1(mean(x)))))`` over the channel axis."""

    def __init__(self, channels: int, squeeze: int, act=nn.ReLU,
                 gate=nn.Sigmoid):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)
        self.act = act()
        self.gate = gate()

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * self.gate(self.fc2(self.act(self.fc1(s))))


def check_min_input(x, name: str, min_input: int, why: str) -> None:
    """Raise where the JAX package does: below ``min_input`` pixels the
    pooling stack empties the feature map."""
    if x.shape[2] < min_input or x.shape[3] < min_input:
        raise ValueError(
            f"{name} needs inputs of at least {min_input}x{min_input} (got "
            f"{x.shape[2]}x{x.shape[3]}): {why} — raise [image] shape in "
            "the training INI")
