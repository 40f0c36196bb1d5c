"""Checks shared by ``tests/test_torch_{efficientnet,mobilenet,vgg,alexnet,
convnext,regnet}.py``: one family of the port's models
(``sykepic_tpu_torch.models``) against the JAX package's Flax modules.

Weights are drawn with numpy from a seed onto the leaves of
``jax.eval_shape`` of the Flax init (an unjitted Flax ``init`` of a deep
net takes a minute on the CPU): kernels normal with He's variance ``2 /
fan_in`` (which keeps ReLU stacks without BatchNorm at scale), biases
``N(0, 0.05)``, norm scales and ConvNeXt's
``layer_scale`` uniform in [0.75, 1.25] (at its 1e-6 init every ConvNeXt
block would be the identity). BatchNorm running statistics for the
forward check are those of a batch of 16 images, the 3 it feeds among
them (a train-mode pass of the port's model), the mean moved by
``N(0, 0.1)`` standard deviations, the variance raised by a tenth of the
layer's mean variance (a channel that is dead on the batch would otherwise
divide by eps alone) and scaled by a uniform [0.9, 1.1]: random, so that
eval-mode BatchNorm is not the identity, yet near the activations' scale,
so that deep stacks neither blow up nor fade (with one fixed draw for
every layer, RegNet's logits reached 1e6 and EfficientNet's stopped
depending on the input).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sykepic_tpu.models import convert_torch
from sykepic_tpu.models import registry as jregistry
from sykepic_tpu.train import trainer as jax_trainer
from sykepic_tpu_torch.models import checkpoint, registry
from sykepic_tpu_torch.models.resnet import BatchNorm2d
from sykepic_tpu_torch.train import trainer as port_trainer

SIZE = 64  # AlexNet's MIN_INPUT is 63
HEAD = (16, 8)
DROPOUT = ((-1, 0.5),)
NUM_CLASSES = 5
# the eval forward: both float32, the conv sums in another order (XLA CPU
# versus oneDNN), as tests/test_torch_resnet.py
RTOL, ATOL = 1e-4, 1e-5


def names(*prefixes) -> list[str]:
    return [n for n in jregistry.MODEL_REGISTRY if n.startswith(prefixes)]


def flax_model(name, dropout=DROPOUT):
    return jregistry.build_model(name, NUM_CLASSES, head=HEAD,
                                 dropout=dropout)


def port_model(name, dropout=DROPOUT):
    return registry.build_model(name, NUM_CLASSES, head=HEAD,
                                dropout=dropout)


@functools.lru_cache(maxsize=None)
def flax_shapes(name):
    """The Flax init's variable tree as ``ShapeDtypeStruct`` leaves."""
    model = flax_model(name)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))


def random_variables(name, seed=0) -> dict:
    """Numpy weights on the Flax tree of ``name`` (module docstring)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [str(getattr(p, "key", p)) for p in path]
        shape = leaf.shape
        if keys[0] == "batch_stats":
            if keys[-1] == "mean":
                return (rng.standard_normal(shape) * 0.1).astype(np.float32)
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if keys[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        if keys[-1] in ("scale", "layer_scale"):
            return rng.uniform(0.75, 1.25, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, flax_shapes(name))
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def flax_init(jmodel, seed=0) -> dict:
    """The Flax model's own initialisation (jitted), as numpy leaves."""
    init = jax.jit(lambda key, x: jmodel.init(key, x, train=False))
    return jax.tree_util.tree_map(np.asarray, dict(init(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))))


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def torch_layout(path, a):
    """A Flax leaf in the torch layout of its key."""
    a = np.asarray(a)
    if path[-1] == "kernel":
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return a


def check_shapes(name):
    """Every parameter and buffer of the port's model against the Flax
    init's leaf at its Flax path (ConvNeXt's ``layer_scale`` (C, 1, 1)
    against (C,)), and no Flax leaf left over."""
    with torch.device("meta"):
        model = port_model(name)
    sd = model.state_dict()
    paths = checkpoint.flax_paths(sd, name)
    want = flax_shapes(name)
    for key, path in paths.items():
        shape = tuple(leaf(want, path).shape)
        if path[-1] == "kernel":  # (kH, kW, I, O) / (I, O) in torch order
            shape = (shape[3], shape[2], *shape[:2]) if len(shape) == 4 \
                else shape[::-1]
        got = tuple(sd[key].shape)
        if path[-1] == "layer_scale":
            got = (int(np.prod(got)),)
        assert got == shape, (key, got, shape)
    flat = {tuple(str(getattr(p, "key", p)) for p in kp)
            for kp, _ in jax.tree_util.tree_leaves_with_path(want)}
    assert flat == set(paths.values())


def images(n, seed) -> np.ndarray:
    """``n`` NHWC noise images, each of its own contrast and level."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.2, 3.0, (n, 1, 1, 1))
    level = rng.uniform(-1.0, 0.5, (n, 1, 1, 1))
    return (rng.random((n, SIZE, SIZE, 3)) * scale + level).astype(
        np.float32)


def batch_statistics(name, variables, x, seed=2) -> dict:
    """Running statistics near the activations of ``x``: the port's model
    in train mode at BatchNorm momentum 0 keeps each layer's batch mean and
    biased variance; then the random moves of the module docstring."""
    model = port_model(name)
    model.load_state_dict(checkpoint.from_flax_variables(
        variables, DROPOUT, name), strict=True)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.flax_momentum = 0.0
    with torch.no_grad():
        model.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    rng = np.random.default_rng(seed)
    for m in norms:
        c = m.num_features
        m.running_mean += torch.from_numpy(
            rng.standard_normal(c).astype(np.float32) * 0.1) * \
            m.running_var.sqrt()
        m.running_var.add_(0.1 * m.running_var.mean()).mul_(
            torch.from_numpy(rng.uniform(0.9, 1.1, c).astype(np.float32)))
    return checkpoint.to_flax_variables(model.state_dict(),
                                        name)["batch_stats"]


def check_forward(name):
    """The eval forward of the port on ``from_flax_variables`` weights
    against the Flax model's, NCHW and channels_last."""
    variables = random_variables(name)
    batch = images(16, seed=1)
    x = batch[:3]
    if variables.get("batch_stats"):
        variables["batch_stats"] = batch_statistics(name, variables, batch)
    jmodel = flax_model(name)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    assert np.std(want, axis=0).max() > 1e-3  # the inputs tell apart
    model = port_model(name)
    model.load_state_dict(checkpoint.from_flax_variables(
        variables, DROPOUT, name), strict=True)
    model.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for fmt in (torch.contiguous_format, torch.channels_last):
        with torch.inference_mode():
            got = model.to(memory_format=fmt)(xt).numpy()
        assert got.shape == (3, NUM_CLASSES)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def check_round_trip(name):
    """``to_flax_variables`` of ``from_flax_variables`` is the tree, leaf
    for leaf and bit for bit; the network is sniffed from the tree."""
    variables = random_variables(name)
    assert checkpoint.sniff_network(variables) == name
    back = checkpoint.to_flax_variables(
        checkpoint.from_flax_variables(variables, DROPOUT), name)
    want = checkpoint._flatten(variables)
    got = checkpoint._flatten(back)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def check_reference_pth(name):
    """The JAX package's exporter writes the reference ``base.N``/``head.K``
    layout; after ``normalize_state_dict`` (the family sniffed from the
    keys) it loads strict, with the same tensors as
    ``from_flax_variables``."""
    variables = random_variables(name)
    ref = convert_torch.flax_to_torch(variables, DROPOUT, name)
    assert any(k.startswith("base.") for k in ref)
    sd = checkpoint.normalize_state_dict(ref)
    port_model(name).load_state_dict(sd, strict=True)
    mine = checkpoint.from_flax_variables(variables, DROPOUT, name)
    assert sd.keys() == mine.keys()
    for k in sd:
        torch.testing.assert_close(sd[k].to(mine[k].dtype), mine[k], atol=0,
                                   rtol=0)


def check_param_groups(name):
    """The port's LR groups equal the JAX package's ``label_params``."""
    with torch.device("meta"):
        model = port_model(name)
    want = jax_trainer.label_params(flax_shapes(name)["params"])
    got = port_trainer.param_groups(model)
    paths = checkpoint.flax_paths(model.state_dict(), name)
    assert len(got) == len(jax.tree_util.tree_leaves(want))
    for key, group in got.items():
        assert group == leaf(want, paths[key][1:]), key
    assert set(got.values()) == {0, 1, 2}
    return got


def check_registry(*prefixes):
    """The port registers the JAX package's names of the family."""
    mine = [n for n in registry.MODEL_REGISTRY if n.startswith(prefixes)]
    assert mine == names(*prefixes) and mine


def check_train_step(jmodel, model, variables):
    """One float32 SGD train step (no augmentation, no dropout) of the JAX
    trainer on ``jmodel`` and the port's on ``model`` (its weights loaded
    from ``variables``), from the same batch
    (``tests/test_torch_trainer.py``'s): the loss within 1e-5 relative;
    every parameter and running variance within 1e-5 of its tensor's
    largest magnitude (a parameter that starts at zero is its step, held
    below), and every running mean within 1e-5 of its layer's
    largest running standard deviation (a batch mean is known to float32
    rounding of the values it averages, not of itself: mobilenet_v3_small's
    ``layer10_0/dw_bn`` means of 2e-3 at most differ by 7.4e-8 on
    activations of unit scale); the step each parameter took (``lr`` times
    its gradient) within 2e-3 of the model's largest step, plus two ulps of
    the tensor's largest starting value (a step read back from float32
    parameters near 1 is known to 1.2e-7). Measured: ConvNeXt's steps
    agree to 1e-5 of its largest; mobilenet_v3_small's, deep in the
    backward pass through train-mode BatchNorm, to 9.8e-4
    (``layer3_0/expand_bn/bias``), where ``tests/test_torch_trainer.py``
    holds ResNet18's gradients to 1e-4 of each tensor's largest."""
    from test_torch_trainer import _batch, _copy

    from sykepic_tpu.train.config import PreprocessSpec as JaxSpec
    from sykepic_tpu.train.input import HostBatch as JaxHostBatch
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.input import HostBatch

    canvas, hs, ws, labels, weights = _batch()
    lrs = (1e-3, 2e-3, 5e-4)  # tests/test_torch_trainer.py's
    jt = jax_trainer.Trainer(jmodel, _copy(variables), optimizer="SGD",
                             preprocess_spec=JaxSpec(SIZE, SIZE, 3, "mode"))
    ls, _, n = jt.train_batch(
        JaxHostBatch(canvas, hs, ws, labels, weights, [None] * len(hs)), 2,
        lrs)
    want = jax.device_get({"params": jt.params,
                           "batch_stats": jt.batch_stats})
    model.load_state_dict(checkpoint.from_flax_variables(
        variables, (), model.network), strict=True)
    pt = port_trainer.Trainer(model, optimizer="SGD",
                              preprocess_spec=PreprocessSpec(SIZE, SIZE, 3,
                                                             "mode"),
                              device="cpu")
    pls, _, pn = pt.train_batch(
        HostBatch(canvas, hs, ws, labels, weights, [None] * len(hs)), 2, lrs)
    assert float(pn) == float(n)
    assert float(pls) / float(pn) == pytest.approx(float(ls) / float(n),
                                                   rel=1e-5)
    got = checkpoint._flatten(pt.variables)
    want = checkpoint._flatten(want)
    start = checkpoint._flatten(variables)
    assert got.keys() == want.keys()
    steps = {p: np.asarray(w) - start[p] for p, w in want.items()
             if p[0] == "params"}
    model_top = max(float(np.abs(v).max()) for v in steps.values())
    moved = 0
    for path, w in want.items():
        w, g = np.asarray(w), got[path]
        scale = float(np.abs(w).max())
        if path[-1] == "mean":  # against the spread of what it averages
            scale = float(np.sqrt(np.asarray(want[path[:-1] + ("var",)])
                                  .max()))
        if path[0] == "batch_stats" or np.any(start[path]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                       err_msg=str(path))
        if path[0] == "params":
            ulp = float(np.spacing(np.abs(start[path]).max()))
            np.testing.assert_allclose(
                g - start[path], steps[path], rtol=0,
                atol=2e-3 * model_top + 2 * ulp, err_msg=str(path))
            moved += float(np.abs(steps[path]).max()) > 1e-3 * model_top
    assert moved > len(want) // 2  # the step reached most parameters

