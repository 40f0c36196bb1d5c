"""INI config parsing -> runtime objects (reference ``sykepic/train/config.py``).

The ``config.ini`` copied into every model directory is the serialized
model-architecture + preprocessing spec; inference re-reads it and training
reads the rest. Section and key names are the reference's, so existing
config files work unchanged:

    [image]  shape, augmentations, border, zoom_range, brightness_range,
             max_rotation, batch_size, num_workers, imagenet_normalization
    [model]  network, weights, head, dropout, id, path, exist_ok
    [dataset]/[train]/[lr_warmup]/[lr_reduction] consumed by the train loop
"""

from __future__ import annotations

from configparser import ConfigParser, NoOptionError
from dataclasses import dataclass

from ..models import build_model


def read_config(path) -> ConfigParser:
    config = ConfigParser()
    if not config.read(path):
        raise FileNotFoundError(path)
    return config


def get_img_shape(config) -> tuple[int, ...]:
    """(C, H, W) from ``image.shape`` (reference ``config.py:20-22``)."""
    return tuple(int(i) for i in config.get("image", "shape").split(","))


@dataclass
class PreprocessSpec:
    """Eval-path preprocessing parameters (device kernel inputs)."""

    target_h: int
    target_w: int
    num_chans: int = 3
    border: str = "mode"
    imagenet_normalization: bool = False


@dataclass
class AugmentSpec:
    """Train-path augmentation parameters (reference ``config.py:25-58``).

    ``augmentations`` entries: flip, translate, zoom, rotate, brightness.
    """

    augmentations: tuple[str, ...] = ()
    zoom_range: tuple[float, float] = (1.0, 1.0)
    brightness_range: tuple[float, float] = (1.0, 1.0)
    max_rotation: int = 0


def get_preprocess_spec(config) -> PreprocessSpec:
    img_shape = get_img_shape(config)
    try:
        imagenet = config.getboolean("image", "imagenet_normalization")
    except NoOptionError:
        imagenet = False
    return PreprocessSpec(
        target_h=img_shape[1],
        target_w=img_shape[2],
        num_chans=img_shape[0],
        border=config.get("image", "border"),
        imagenet_normalization=imagenet,
    )


def get_augment_spec(config) -> AugmentSpec:
    augs = tuple(
        a.strip()
        for a in config.get("image", "augmentations").split(",")
        if a.strip()
    )
    spec = AugmentSpec(augmentations=augs)
    if "zoom" in augs:
        spec.zoom_range = tuple(
            float(i) for i in config.get("image", "zoom_range").split(",")
        )
    if "brightness" in augs:
        spec.brightness_range = tuple(
            float(i) for i in config.get("image", "brightness_range").split(",")
        )
    if "rotate" in augs:
        spec.max_rotation = config.getint("image", "max_rotation")
    return spec


def get_head_spec(config):
    """``(head_sizes, dropout_spec)`` from ``[model]``; the dropout spec
    also fixes the head's torch Sequential indices."""
    head = [int(i) for i in config.get("model", "head").split(",")]
    dropout = []
    if config.get("model", "dropout"):
        for drop in config.get("model", "dropout").split(";"):
            idx, p = drop.split(",")
            dropout.append((int(idx), float(p)))
    return head, dropout


def get_network(config, num_classes: int):
    """Build the model from ``[model]`` (reference ``config.py:63-77``).

    Returns ``(model, weights_spec)``; ``weights_spec`` mirrors the
    reference's ``weights`` option ("DEFAULT" for old configs) and matters
    only when training starts. The model holds float32 parameters; the
    compute dtype of ``[train] dtype`` is an autocast around its forward
    (:class:`sykepic_tpu_torch.train.trainer.Trainer`), where the JAX
    package builds the Flax module with ``dtype=``.
    """
    network = config.get("model", "network")
    try:
        weights = config.get("model", "weights") or None
    except NoOptionError:
        weights = "DEFAULT"
    head, dropout = get_head_spec(config)
    model = build_model(network, num_classes, head=head, dropout=dropout)
    return model, weights
