"""The port's EfficientNet B0-B7 and V2 S/M/L
(``sykepic_tpu_torch/models/efficientnet.py``) against the JAX package's
(``sykepic_tpu/models/efficientnet.py``), on the CPU: parameter shapes and
LR groups of every variant, and on ``efficientnet_b0`` and
``efficientnet_v2_s`` (FusedMBConv, BatchNorm eps 1e-3) the eval forward
at 64x64 within ``rtol=1e-4, atol=1e-5``, the variable-tree round trip and
the reference ``.pth`` layout (``tests/torch_families.py``)."""

import pytest
import torch

import torch_families as tf

NAMES = tf.names('efficientnet',)
SMALL = ['efficientnet_b0', 'efficientnet_v2_s']


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_registry_names_equal_jax():
    tf.check_registry('efficientnet',)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_shapes_match_flax(name):
    tf.check_shapes(name)


@pytest.mark.parametrize("name", NAMES)
def test_param_groups_equal_label_params(name):
    groups = tf.check_param_groups(name)
    last = max(int(k.split(".")[1]) for k in groups
               if k.startswith("features."))
    # the last stage's convolutions and the 1x1 head conv: group 1
    assert all(g == 1 for k, g in groups.items()
               if k.startswith((f"features.{last}.", f"features.{last - 1}."))
               and k.endswith("0.weight"))


@pytest.mark.parametrize("name", SMALL)
def test_eval_forward_matches_flax(name):
    tf.check_forward(name)


@pytest.mark.parametrize("name", SMALL)
def test_variable_round_trip(name):
    tf.check_round_trip(name)


@pytest.mark.parametrize("name", SMALL)
def test_reference_pth_loads_strict(name):
    tf.check_reference_pth(name)
