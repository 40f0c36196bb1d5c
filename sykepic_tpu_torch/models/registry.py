"""Model registry: name -> constructor (the reference used ``getattr(torchvision
.models, name)``, ``sykepic/train/network.py:48``): the JAX package's 50
names, ``sykepic_tpu/models/registry.py:13-64``, then the port's own Swin
Transformers (``swin_t``, ``swin_s``, ``swin_b``), which the JAX package
lacks.
"""

from __future__ import annotations

import torch
from torch import nn

from . import (alexnet, convnext, efficientnet, mobilenet, regnet, resnet,
               swin, vgg)

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
    "efficientnet_b0": efficientnet.efficientnet_b0,
    "efficientnet_b1": efficientnet.efficientnet_b1,
    "efficientnet_b2": efficientnet.efficientnet_b2,
    "efficientnet_b3": efficientnet.efficientnet_b3,
    "efficientnet_b4": efficientnet.efficientnet_b4,
    "efficientnet_b5": efficientnet.efficientnet_b5,
    "efficientnet_b6": efficientnet.efficientnet_b6,
    "efficientnet_b7": efficientnet.efficientnet_b7,
    "efficientnet_v2_s": efficientnet.efficientnet_v2_s,
    "efficientnet_v2_m": efficientnet.efficientnet_v2_m,
    "efficientnet_v2_l": efficientnet.efficientnet_v2_l,
    "mobilenet_v3_large": mobilenet.mobilenet_v3_large,
    "mobilenet_v3_small": mobilenet.mobilenet_v3_small,
    "vgg11": vgg.vgg11,
    "vgg11_bn": vgg.vgg11_bn,
    "vgg13": vgg.vgg13,
    "vgg13_bn": vgg.vgg13_bn,
    "vgg16": vgg.vgg16,
    "vgg16_bn": vgg.vgg16_bn,
    "vgg19": vgg.vgg19,
    "vgg19_bn": vgg.vgg19_bn,
    "alexnet": alexnet.alexnet,
    "convnext_tiny": convnext.convnext_tiny,
    "convnext_small": convnext.convnext_small,
    "convnext_base": convnext.convnext_base,
    "convnext_large": convnext.convnext_large,
    "regnet_x_400mf": regnet.regnet_x_400mf,
    "regnet_x_800mf": regnet.regnet_x_800mf,
    "regnet_x_1_6gf": regnet.regnet_x_1_6gf,
    "regnet_x_3_2gf": regnet.regnet_x_3_2gf,
    "regnet_x_8gf": regnet.regnet_x_8gf,
    "regnet_x_16gf": regnet.regnet_x_16gf,
    "regnet_x_32gf": regnet.regnet_x_32gf,
    "regnet_y_400mf": regnet.regnet_y_400mf,
    "regnet_y_800mf": regnet.regnet_y_800mf,
    "regnet_y_1_6gf": regnet.regnet_y_1_6gf,
    "regnet_y_3_2gf": regnet.regnet_y_3_2gf,
    "regnet_y_8gf": regnet.regnet_y_8gf,
    "regnet_y_16gf": regnet.regnet_y_16gf,
    "regnet_y_32gf": regnet.regnet_y_32gf,
    "swin_t": swin.swin_t,
    "swin_s": swin.swin_s,
    "swin_b": swin.swin_b,
}


def build_model(name: str, num_classes: int, head=(256, 128), dropout=()):
    """Build a model by torchvision-style name (reference
    ``config.py:63-77``). The model keeps its name in ``.network``, which
    picks its key map in :mod:`~sykepic_tpu_torch.models.checkpoint`."""
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown network '{name}'. Available: {sorted(MODEL_REGISTRY)}"
        )
    model = MODEL_REGISTRY[name](
        num_classes=num_classes,
        head=tuple(head),
        dropout=tuple(tuple(d) for d in dropout),
    )
    model.network = name
    return model


# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so the kept part has variance 1 / fan_in (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random initialisation in place, with the distributions the
    JAX package's Flax modules draw from (``models/registry.py::
    init_variables``): convolution and linear weights lecun-normal
    (truncated normal, variance ``1 / fan_in``), biases zero, BatchNorm
    and LayerNorm scale 1 and shift 0, running mean 0 and variance 1,
    ConvNeXt's ``layer_scale`` 1e-6; Swin's relative-position bias tables,
    which the JAX package lacks, truncated normal of std 0.02 as
    torchvision draws them. The numbers come from a ``torch.Generator``
    seeded with ``seed``, so they are not JAX's."""
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
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, convnext.CNBlock):
                m.layer_scale.fill_(convnext.LAYER_SCALE_INIT)
            elif isinstance(m, swin.ShiftedWindowAttention):
                t = m.relative_position_bias_table
                w = torch.empty(t.shape)
                nn.init.trunc_normal_(w, std=0.02, generator=g)
                t.copy_(w)
    return model
