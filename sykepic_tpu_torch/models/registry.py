"""Model registry: name -> constructor (the reference used ``getattr(torchvision
.models, name)``, ``sykepic/train/network.py:48``).

This slice of the port carries the ResNet family only; the JAX package's
other families are ROADMAP slice 5.
"""

from __future__ import annotations

import torch
from torch import nn

from . import resnet

MODEL_REGISTRY = {
    "resnet18": resnet.resnet18,
    "resnet34": resnet.resnet34,
    "resnet50": resnet.resnet50,
    "resnet101": resnet.resnet101,
    "resnet152": resnet.resnet152,
    "resnext50_32x4d": resnet.resnext50_32x4d,
    "resnext101_32x8d": resnet.resnext101_32x8d,
    "resnext101_64x4d": resnet.resnext101_64x4d,
    "wide_resnet50_2": resnet.wide_resnet50_2,
    "wide_resnet101_2": resnet.wide_resnet101_2,
}

# families the JAX package builds that this port does not have yet
_LATER_FAMILIES = ("efficientnet", "mobilenet", "vgg", "alexnet", "convnext",
                   "regnet")


def build_model(name: str, num_classes: int, head=(256, 128), dropout=()):
    """Build a model by torchvision-style name (reference
    ``config.py:63-77``)."""
    if name not in MODEL_REGISTRY:
        if name.startswith(_LATER_FAMILIES):
            raise NotImplementedError(
                f"'{name}' is not ported yet: the port builds the ResNet "
                "family only; the other families are ROADMAP slice 5"
            )
        raise ValueError(
            f"Unknown network '{name}'. Available: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[name](
        num_classes=num_classes,
        head=tuple(head),
        dropout=tuple(tuple(d) for d in dropout),
    )


# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so the kept part has variance 1 / fan_in (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random initialisation in place, with the distributions the
    JAX package's Flax modules draw from (``models/registry.py::
    init_variables``): convolution and linear weights lecun-normal
    (truncated normal, variance ``1 / fan_in``), biases zero, BatchNorm
    scale 1, shift 0, running mean 0 and variance 1. The numbers come from
    a ``torch.Generator`` seeded with ``seed``, so they are not JAX's."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=g)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
