"""The port's MobileNetV3 large/small (``sykepic_tpu_torch/models/
mobilenet.py``) against the JAX package's (``sykepic_tpu/models/
mobilenet.py``), on the CPU: parameter shapes and LR groups of both, and
on both the eval forward at 64x64 within ``rtol=1e-4, atol=1e-5``, the
variable-tree round trip and the reference ``.pth`` layout
(``tests/torch_families.py``); one float32 train step of
``mobilenet_v3_small`` (BatchNorm momentum 0.99, eps 1e-3) against the JAX
trainer's (``tests/test_torch_trainer.py``'s machinery)."""

import pytest
import torch

import torch_families as tf

NAMES = tf.names('mobilenet',)
SMALL = ['mobilenet_v3_small', 'mobilenet_v3_large']


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_registry_names_equal_jax():
    tf.check_registry('mobilenet',)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_shapes_match_flax(name):
    tf.check_shapes(name)


@pytest.mark.parametrize("name", NAMES)
def test_param_groups_equal_label_params(name):
    groups = tf.check_param_groups(name)
    last = max(int(k.split(".")[1]) for k in groups
               if k.startswith("features."))
    # the last block's convolutions and the widening head conv: group 1
    assert all(g == 1 for k, g in groups.items()
               if k.startswith((f"features.{last}.", f"features.{last - 1}."))
               and k.endswith(".0.weight"))


@pytest.mark.parametrize("name", SMALL)
def test_eval_forward_matches_flax(name):
    tf.check_forward(name)


@pytest.mark.parametrize("name", SMALL)
def test_variable_round_trip(name):
    tf.check_round_trip(name)


@pytest.mark.parametrize("name", SMALL)
def test_reference_pth_loads_strict(name):
    tf.check_reference_pth(name)


def test_one_train_step_matches_jax(monkeypatch):
    """``mobilenet_v3_small``: BatchNorm momentum 0.99 and eps 1e-3.

    Flax's ``BatchNorm`` takes the one-pass variance ``E[x^2] - E[x]^2`` in
    float32 (``use_fast_variance``); on this batch that moves Flax's
    train-mode logits by 2.8e-4 (of 3.8) from the port's two-pass
    variance, and Flax's own two-pass variance brings the gap to 2.6e-5.
    So the JAX step runs with it here."""
    import flax.linen.normalization as flax_norm

    stats = flax_norm._compute_stats

    def two_pass(*args, **kw):
        kw["use_fast_variance"] = False
        return stats(*args, **kw)

    monkeypatch.setattr(flax_norm, "_compute_stats", two_pass)
    name = "mobilenet_v3_small"
    jmodel = tf.flax_model(name, dropout=())
    tf.check_train_step(jmodel, tf.port_model(name, dropout=()),
                        tf.flax_init(jmodel))
