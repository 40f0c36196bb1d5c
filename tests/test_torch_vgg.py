"""The port's VGG 11/13/16/19 with and without BatchNorm
(``sykepic_tpu_torch/models/vgg.py``) against the JAX package's
(``sykepic_tpu/models/vgg.py``), on the CPU: parameter shapes and LR groups
of every variant, and on ``vgg11`` and ``vgg11_bn`` the eval forward at
64x64 (a 2x2 map reaches the 7x7 adaptive pool: overlapping windows)
within ``rtol=1e-4, atol=1e-5``, the variable-tree round trip and the
reference ``.pth`` layout (``tests/torch_families.py``); the small-input
``ValueError``."""

import pytest
import torch

import torch_families as tf

NAMES = tf.names('vgg',)
SMALL = ['vgg11', 'vgg11_bn']


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_registry_names_equal_jax():
    tf.check_registry('vgg',)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_shapes_match_flax(name):
    tf.check_shapes(name)


@pytest.mark.parametrize("name", NAMES)
def test_param_groups_equal_label_params(name):
    groups = tf.check_param_groups(name)
    last = max((k for k in groups if k.startswith("features.")
                and groups[k] != 0), key=lambda k: int(k.split(".")[1]))
    assert groups[last] == 1 and groups["features.0.weight"] == 2


@pytest.mark.parametrize("name", SMALL)
def test_eval_forward_matches_flax(name):
    tf.check_forward(name)


@pytest.mark.parametrize("name", SMALL)
def test_variable_round_trip(name):
    tf.check_round_trip(name)


@pytest.mark.parametrize("name", SMALL)
def test_reference_pth_loads_strict(name):
    tf.check_reference_pth(name)


def test_small_inputs_raise():
    model = tf.port_model("vgg11").eval()
    with pytest.raises(ValueError, match="at least"):
        model(torch.zeros(1, 3, 31, 64))
