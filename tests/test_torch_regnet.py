"""The port's RegNet X and Y (``sykepic_tpu_torch/models/regnet.py``)
against the JAX package's (``sykepic_tpu/models/regnet.py``), on the CPU:
parameter shapes and LR groups of every variant, and on ``regnet_x_400mf``
and ``regnet_y_400mf`` (squeeze-excitation sized from the block's input)
the eval forward at 64x64 within ``rtol=1e-4, atol=1e-5``, the
variable-tree round trip and the reference ``.pth`` layout
(``tests/torch_families.py``)."""

import pytest
import torch

import torch_families as tf

NAMES = tf.names('regnet',)
SMALL = ['regnet_x_400mf', 'regnet_y_400mf']


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_registry_names_equal_jax():
    tf.check_registry('regnet',)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_shapes_match_flax(name):
    tf.check_shapes(name)


@pytest.mark.parametrize("name", NAMES)
def test_param_groups_equal_label_params(name):
    groups = tf.check_param_groups(name)
    assert all(g == 1 for k, g in groups.items()
               if k.startswith("trunk_output.block4.")
               and ".1." not in k and not k.endswith(".1.weight"))


@pytest.mark.parametrize("name", SMALL)
def test_eval_forward_matches_flax(name):
    tf.check_forward(name)


@pytest.mark.parametrize("name", SMALL)
def test_variable_round_trip(name):
    tf.check_round_trip(name)


@pytest.mark.parametrize("name", SMALL)
def test_reference_pth_loads_strict(name):
    tf.check_reference_pth(name)
