"""The port's ConvNeXt tiny/small/base/large (``sykepic_tpu_torch/models/
convnext.py``) against the JAX package's (``sykepic_tpu/models/
convnext.py``), on the CPU: parameter shapes and LR groups of every
variant (LayerNorms go with their stage), and on ``convnext_tiny`` the
eval forward at 64x64 within ``rtol=1e-4, atol=1e-5``, the variable-tree
round trip and the reference ``.pth`` layout (``tests/torch_families.py``);
one float32 train step of ``convnext_tiny`` at stochastic depth 0
(LayerNorm, ``layer_scale``, GELU) against the JAX trainer's; stochastic
depth's survivor share and scale; the small-input ``ValueError``; a
directory the port trains, read by the JAX package."""

import pytest
import torch

import torch_families as tf

NAMES = tf.names('convnext',)
SMALL = ['convnext_tiny']


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_registry_names_equal_jax():
    tf.check_registry('convnext',)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_shapes_match_flax(name):
    tf.check_shapes(name)


@pytest.mark.parametrize("name", NAMES)
def test_param_groups_equal_label_params(name):
    groups = tf.check_param_groups(name)
    # stage 4 (blocks and downsample), its LayerNorms included: group 1
    assert all(g == 1 for k, g in groups.items()
               if k.startswith(("features.6.", "features.7.")))
    assert all(g == 2 for k, g in groups.items()
               if k.startswith("features.0."))


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
    model = tf.port_model("convnext_tiny").eval()
    with pytest.raises(ValueError, match="at least"):
        model(torch.zeros(1, 3, 64, 31))


def test_one_train_step_matches_jax():
    """``convnext_tiny`` at stochastic depth 0: LayerNorm, ``layer_scale``
    and the exact GELU through the backward pass."""
    from sykepic_tpu.models import convnext as jax_convnext
    from sykepic_tpu_torch.models import convnext

    dims, blocks, _ = convnext.CONVNEXT_CFGS["convnext_tiny"]
    jmodel = jax_convnext.ConvNeXt(dims=dims, blocks=blocks, sd_prob=0.0,
                                   num_classes=tf.NUM_CLASSES, head=tf.HEAD)
    model = convnext.ConvNeXt(dims, blocks, 0.0, tf.NUM_CLASSES,
                              head=tf.HEAD)
    model.network = "convnext_tiny"
    tf.check_train_step(jmodel, model, tf.random_variables("convnext_tiny"))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_stochastic_depth_keeps_rows_at_one_minus_p(p):
    """Row mode: whole samples survive with probability ``1 - p`` (within
    five standard deviations of 20,000 draws) and survivors are scaled by
    ``1 / (1 - p)``; the identity in evaluation and at ``p = 0``; a seeded
    generator repeats."""
    from sykepic_tpu_torch.models.resnet import StochasticDepth

    n = 20_000
    x = torch.rand(n, 3, 2, 2) + 0.5
    sd = StochasticDepth(p).train()
    sd.generator = torch.Generator().manual_seed(0)
    y = sd(x)
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | ~kept.any(1)).all())  # whole rows
    share = float(kept.all(1).float().mean())
    assert abs(share - (1 - p)) < 5 * ((p * (1 - p) / n) ** 0.5)
    rows = kept.all(1)
    torch.testing.assert_close(y[rows], x[rows] / (1 - p))
    sd.generator = torch.Generator().manual_seed(0)
    assert torch.equal(sd(x), y)
    assert torch.equal(sd.eval()(x), x)
    assert torch.equal(StochasticDepth(0.0).train()(x), x)


def test_trainer_hands_its_generator_to_stochastic_depth():
    from sykepic_tpu_torch.models.resnet import StochasticDepth
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.trainer import Trainer

    t = Trainer(tf.port_model("convnext_tiny"), device="cpu",
                preprocess_spec=PreprocessSpec(32, 32))
    depths = [m for m in t.model.modules() if isinstance(m, StochasticDepth)]
    assert len(depths) == 18 and depths[0].p == 0.0
    assert depths[-1].p == pytest.approx(0.1)
    assert all(m.generator is t.gen for m in depths)


def test_port_trained_convnext_reads_in_jax(tmp_path):
    """A ``convnext_tiny`` directory trained for one epoch by the port's
    ``train --device cpu`` is read by the JAX package's ``load_variables``,
    and the Flax model's logits on it equal the port's within the eval
    forward's bound."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from test_torch_train_loop import CONFIG, _dataset

    from sykepic_tpu.models import checkpoint as jax_checkpoint
    from sykepic_tpu.train import config as jax_config
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.models import checkpoint
    from sykepic_tpu_torch.train import config as tcfg

    ini = tmp_path / "train.ini"
    ini.write_text(CONFIG.format(dataset=_dataset(tmp_path / "dataset"),
                                 models=tmp_path / "models", norm="no")
                   .replace("network = resnet18", "network = convnext_tiny")
                   .replace("max_epochs = 2", "max_epochs = 1"))
    model_dir = main(["train", str(ini), "--device", "cpu"])
    assert model_dir.name == "convnext_tiny_1"
    tree = jax_checkpoint.load_variables(model_dir / "best_state.msgpack")
    config = jax_config.read_config(model_dir / "config.ini")
    jmodel, _ = jax_config.get_network(config, 3)
    x = np.random.default_rng(1).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        tree, jnp.asarray(x)))

    port_cfg = tcfg.read_config(model_dir / "config.ini")
    model, _ = tcfg.get_network(port_cfg, 3)
    _, dropout = tcfg.get_head_spec(port_cfg)
    model.load_state_dict(checkpoint.load_model_state(
        model_dir, dropout, network=model.network))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=tf.RTOL, atol=tf.ATOL)
    # epoch 1 is warmup stage 0: the head trains, the backbone holds
    np.testing.assert_array_equal(
        tree["params"]["layer4_2"]["layer_scale"], np.float32(1e-6))
