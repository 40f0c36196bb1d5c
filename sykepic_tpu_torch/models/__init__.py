from .resnet import ResNet, BasicBlock, Bottleneck  # noqa: F401
from .registry import build_model, MODEL_REGISTRY  # noqa: F401
from . import checkpoint  # noqa: F401
