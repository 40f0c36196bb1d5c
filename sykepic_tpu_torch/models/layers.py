"""torchvision's building blocks that several families share, with
torchvision's child names, so each family's ``state_dict`` keeps
torchvision's key layout (``features.3.1.block.0.1.running_var``,
``trunk_output.block2.block2-0.f.se.fc1.weight``, ...).

- :class:`ConvNormAct` is ``Conv2dNormActivation``: ``0`` the convolution,
  ``1`` the norm, ``2`` the activation (absent when ``act`` is None).
  In an eval forward on the card (:func:`eval_kernel_runs`) a depthwise
  convolution the hand-written kernel takes
  (:func:`sykepic_tpu_torch.ops.depthwise.takes`, no bias) runs as that
  kernel, one launch a call, and its NHWC output goes on to the norm as the
  channels_last NCHW view; everywhere else cuDNN runs it as before.
- :func:`eval_kernel_runs` is the one rule that sends an eval forward to
  the port's hand-written kernels (this depthwise convolution, and the
  LayerNorm of ConvNeXt and Swin in ``models/convnext.py`` and
  ``models/swin.py``); :func:`conv_no_bias` runs the convolution before
  such a LayerNorm, which adds its bias.
- :class:`SqueezeExcitation` is ``ops.SqueezeExcitation``: global mean ->
  ``fc1`` 1x1 (bias) -> ``act`` -> ``fc2`` 1x1 (bias) -> ``gate`` -> scale.
- :func:`check_min_input` is the JAX package's small-input ``ValueError``
  of VGG, AlexNet and ConvNeXt.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import depthwise
from .resnet import BatchNorm2d


def eval_kernel_runs(x: torch.Tensor, module: nn.Module) -> bool:
    """Whether ``module``'s forward of ``x`` (NCHW) runs the eval kernels
    (:mod:`sykepic_tpu_torch.ops.depthwise`,
    :mod:`sykepic_tpu_torch.ops.layernorm`): ``x`` is a float32 CUDA tensor
    in channels_last (so its NHWC view, and that of a convolution's output,
    is contiguous), autocast is off, and no gradient is recorded (none is
    enabled, or neither ``x`` nor any parameter of ``module`` requires
    one): the kernels have no backward."""
    return (x.is_cuda and x.dtype == torch.float32
            and x.is_contiguous(memory_format=torch.channels_last)
            and not torch.is_autocast_enabled(x.device.type)
            and not (torch.is_grad_enabled() and (
                x.requires_grad
                or any(p.requires_grad for p in module.parameters()))))


def conv_no_bias(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` of ``x`` (NCHW) without its bias, in NHWC: the depthwise
    kernel where it takes ``conv`` (ConvNeXt's 7x7), else cuDNN's
    channels_last output as a free view (a copy only where it gave none).
    The LayerNorm kernel that follows adds the bias (``pre_bias``)."""
    if depthwise.takes(conv):
        return depthwise.depthwise(x.permute(0, 2, 3, 1), conv.weight,
                                   conv.stride[0])
    return conv._conv_forward(x, conv.weight, None).permute(
        0, 2, 3, 1).contiguous()


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

    def forward(self, x):
        layers = iter(self)
        conv = next(layers)
        if (not depthwise.takes(conv) or conv.bias is not None
                or not eval_kernel_runs(x, self)):
            return super().forward(x)
        x = depthwise.depthwise(x.permute(0, 2, 3, 1), conv.weight,
                                conv.stride[0]).permute(0, 3, 1, 2)
        for layer in layers:
            x = layer(x)
        return x


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
