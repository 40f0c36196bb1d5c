"""Model registry: name -> constructor (the reference used ``getattr(torchvision
.models, name)``, ``sykepic/train/network.py:48``).

This slice of the port carries the ResNet family only; the JAX package's
other families are ROADMAP slice 5.
"""

from __future__ import annotations

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
