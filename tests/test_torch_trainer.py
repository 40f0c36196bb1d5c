"""The port's trainer (``sykepic_tpu_torch/train/trainer.py``) against the
JAX package's (``sykepic_tpu/train/trainer.py``), on the CPU, at a small
size (ResNet18 with a 16-wide head on 32x32 inputs).

- ``label_params``: the same LR groups, carried to torch names.
- ``LRSchedule``: ``tests/test_lr_schedule.py``'s cases, and the JAX class's
  lrs and stages on a long run.
- One train step for Adam, AdamW, SGD and RMSprop from the same weights and
  batch (float32, no augmentation, no dropout): the loss within 1e-5
  relative; each gradient within 1e-4 of its tensor's largest magnitude;
  ``batch_stats`` within 1e-5 relative. Parameters: equal (1e-5 relative)
  to optax's transform applied to the port's own gradients; and within 1%
  of the tensor's largest step of the JAX step's parameters where the
  gradient is over 1e-2 of its tensor's largest, so known to 1%. (On the
  first Adam step ``m / (sqrt(v) + eps)`` is about +-1 for any nonzero
  gradient, and RMSprop's ``g / sqrt(0.01 g^2 + eps)`` follows ``g``
  where ``g^2`` is near ``100 eps``: gradients at the tolerance's edge move
  a parameter by up to 2 lr. Measured at ``|g| > 1e-6 max|g|``: 1 of
  36,864 entries of ``layer1.0.conv1`` under Adam, 45 of 9,405 of
  ``conv1`` under RMSprop.)
- Frozen groups are bit-unchanged in stages 0 and 1.
- Eval loss, correct and predictions equal.
- The per-step mixed loop equals the whole-epoch call bit for bit.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sykepic_tpu.models.registry import build_model as jax_build
from sykepic_tpu.models.registry import init_variables
from sykepic_tpu.train import trainer as jax_trainer
from sykepic_tpu.train.config import PreprocessSpec as JaxSpec
from sykepic_tpu.train.input import HostBatch as JaxHostBatch
from sykepic_tpu_torch.models import checkpoint, registry
from sykepic_tpu_torch.ops import resize_pad
from sykepic_tpu_torch.train import trainer as port
from sykepic_tpu_torch.train.config import PreprocessSpec
from sykepic_tpu_torch.train.device_data import DeviceDataset
from sykepic_tpu_torch.train.input import HostBatch

WARMUP = dict(factor_1=0.1, factor_2=0.5, step_1=4, step_2=14, step_3=24)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_variables():
    model = jax_build("resnet18", num_classes=3, head=(16,))
    return model, jax.device_get(init_variables(model, (32, 32, 3), seed=0))


def _copy(tree):
    return jax.tree.map(np.copy, tree)


def _port_model(variables):
    model = registry.build_model("resnet18", 3, head=(16,))
    model.load_state_dict(checkpoint.from_flax_variables(variables))
    return model


def _batch(seed=0, b=8):
    rng = np.random.default_rng(seed)
    hs = rng.integers(8, 24, b).astype(np.int32)
    ws = rng.integers(8, 40, b).astype(np.int32)
    canvas = np.zeros((b, 24, 40), np.uint8)
    for i in range(b):
        canvas[i, :hs[i], :ws[i]] = rng.integers(0, 256, (hs[i], ws[i]))
    labels = (np.arange(b) % 3).astype(np.int32)
    weights = np.ones(b, np.float32)
    weights[-1] = 0.0  # a wrapped pad slot
    return canvas, hs, ws, labels, weights


def _torch_layout(name, a):
    a = np.asarray(a, np.float32)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if name.startswith("head.") and a.ndim == 2:
        return a.T
    return a


def _leaf(tree, name, paths):
    node = tree
    for k in paths[name][1:]:
        node = node[k]
    return node


@pytest.mark.parametrize("network", ["resnet18", "resnet50"])
def test_label_params_groups_equal(network):
    model = jax_build(network, num_classes=4, head=(8,))
    variables = init_variables(model, (32, 32, 3), seed=0)
    want = jax_trainer.label_params(variables["params"])
    ported = registry.build_model(network, 4, head=(8,))
    got = port.param_groups(ported)
    paths = checkpoint.flax_paths(ported.state_dict())
    assert len(got) == len(jax.tree.leaves(want))
    for name, group in got.items():
        assert group == _leaf(want, name, paths), name
    assert set(got.values()) == {0, 1, 2}
    assert all(g == 1 for n, g in got.items()
               if n.startswith("layer4") and ".bn" not in n
               and "downsample.1" not in n)


def test_warmup_stages_and_factors():
    s = port.LRSchedule(0.01, warmup=WARMUP)
    assert s.lrs == [0.01, 0.0, 0.0] and s.stage == 0
    for e in range(1, 4):
        s.start_epoch(e)
        assert s.lrs[0] == 0.01
    s.start_epoch(4)
    assert s.lrs[0] == pytest.approx(0.001) and s.stage == 0
    s.start_epoch(14)
    assert s.lrs[1] == pytest.approx(0.0001)
    assert s.lrs[0] == pytest.approx(0.0005) and s.stage == 1
    s.start_epoch(24)
    assert s.lrs[2] == pytest.approx(0.00001)
    assert s.lrs[1] == pytest.approx(0.0001)
    assert s.lrs[0] == pytest.approx(0.00025) and s.stage == 2


def test_plateau_counts_only_after_warmup():
    s = port.LRSchedule(0.01, warmup=WARMUP,
                        reduction=dict(factor=0.1, patience=2))
    for e in range(1, 25):
        s.start_epoch(e)
    after = list(s.lrs)
    for e in range(1, 25):
        s.end_epoch(e, val_loss=1.0)
    assert s.lrs == after
    for e in (25, 26, 27):
        s.end_epoch(e, 1.0)
    assert s.lrs == after
    s.end_epoch(28, 1.0)
    assert s.lrs == pytest.approx([lr * 0.1 for lr in after])
    s.end_epoch(29, 0.5)
    s.end_epoch(30, 0.51)
    s.end_epoch(31, 0.51)
    before = list(s.lrs)
    s.end_epoch(32, 0.49)
    s.end_epoch(33, 0.49)
    assert s.lrs == before


def test_no_warmup_no_stage_changes():
    s = port.LRSchedule(0.01)
    for e in range(1, 100):
        s.start_epoch(e)
        s.end_epoch(e, 1.0)
    assert s.stage == 0 and s.lrs == [0.01, 0.0, 0.0]


def test_plateau_without_warmup_counts_immediately():
    s = port.LRSchedule(0.01, reduction=dict(factor=0.5, patience=0))
    s.end_epoch(1, 1.0)
    s.end_epoch(2, 1.0)
    assert s.lrs[0] == pytest.approx(0.005)


def test_schedule_equals_jax_on_a_long_run():
    rng = np.random.default_rng(0)
    kw = dict(warmup=WARMUP, reduction=dict(factor=0.3, patience=1))
    a, b = port.LRSchedule(0.02, **kw), jax_trainer.LRSchedule(0.02, **kw)
    for e in range(1, 60):
        a.start_epoch(e)
        b.start_epoch(e)
        loss = float(rng.uniform(0.5, 1.0))
        a.end_epoch(e, loss)
        b.end_epoch(e, loss)
        assert a.lrs == b.lrs and a.stage == b.stage
        assert a.snapshot() == b.snapshot()
    c = port.LRSchedule(1.0)
    c.restore(b.snapshot())
    assert c.snapshot() == b.snapshot()


def _jax_grads(jt, hb):
    """The JAX step's loss and gradients on ``hb`` (its own preprocess and
    loss, ``trainer.py:225-242``), before any update."""
    args = jt._batch_device_args(hb)
    x = jt._device_preprocess(*args[:10], None, train=True)
    y, wts = args[10], args[11]

    def loss_fn(p):
        logits, mutated = jt.model.apply(
            {"params": p, "batch_stats": jt.batch_stats}, x, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        losses = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), y)
        return jnp.sum(losses * wts) / jnp.maximum(jnp.sum(wts), 1.0)

    return jax.value_and_grad(loss_fn)(jt.params)


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW", "SGD", "RMSprop"])
def test_one_step_matches_jax(jax_variables, optimizer):
    jmodel, variables = jax_variables
    canvas, hs, ws, labels, weights = _batch()
    spec = JaxSpec(32, 32, 3, border="mode")
    lrs = (1e-3, 2e-3, 5e-4)
    jt = jax_trainer.Trainer(jmodel, _copy(variables), optimizer=optimizer,
                             preprocess_spec=spec, seed=0)
    jhb = JaxHostBatch(canvas, hs, ws, labels, weights, [None] * len(hs))
    jloss, jgrads = _jax_grads(jt, jhb)
    ls, c, n = jt.train_batch(jhb, 2, lrs)
    want_loss = float(ls) / float(n)
    # the JAX step's own float32 sums, in another order than loss_fn's
    assert want_loss == pytest.approx(float(jloss), rel=1e-5)

    model = _port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pt = port.Trainer(model, optimizer=optimizer,
                      preprocess_spec=PreprocessSpec(32, 32, 3, "mode"),
                      device="cpu")
    pls, pc, pn = pt.train_batch(
        HostBatch(canvas, hs, ws, labels, weights, [None] * len(hs)), 2, lrs)
    assert float(pn) == float(n) and float(pc) == float(c)
    assert float(pls) / float(pn) == pytest.approx(want_loss, rel=1e-5)

    paths = checkpoint.flax_paths(before)
    jparams = jax.device_get(jt.params)
    jstats = jax.device_get(jt.batch_stats)
    # optax's own transform on the port's gradients, from the same weights
    tx = jax_trainer.make_optimizer(optimizer)
    flax_grads = checkpoint.to_flax_variables(
        dict(zip(pt.names, pt.grads)))["params"]
    p0 = _copy(variables["params"])
    updates, _ = tx.update(flax_grads, tx.init(p0), p0)
    for name, g, p in zip(pt.names, pt.grads, pt.params):
        jg = _torch_layout(name, _leaf(jgrads, name, paths))
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=name)
        lr = lrs[pt.labels[pt.names.index(name)]]
        got = p.detach().numpy()
        start = before[name].numpy()
        want = start - lr * _torch_layout(name, _leaf(updates, name, paths))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * lr,
                                   err_msg=name)
        # against the JAX step itself, where its gradient is known to 1%
        jp = _torch_layout(name, _leaf(jparams, name, paths))
        live = np.abs(jg) > 1e-2 * scale
        np.testing.assert_allclose(
            got[live], jp[live], rtol=0,
            atol=1e-2 * float(np.abs(jp - start).max()) + 1e-12,
            err_msg=name)
    for name, v in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            jv = np.asarray(_leaf(jstats, name, paths))
            np.testing.assert_allclose(
                v.numpy(), jv, rtol=1e-5,
                atol=1e-5 * float(np.abs(jv).max()), err_msg=name)
            assert not torch.equal(v, before[name])  # the step moved them


@pytest.mark.parametrize("stage", [0, 1])
def test_frozen_groups_are_bit_unchanged(jax_variables, stage):
    _, variables = jax_variables
    model = _port_model(variables)
    pt = port.Trainer(model, optimizer="Adam",
                      preprocess_spec=PreprocessSpec(32, 32, 3, "mode"),
                      device="cpu")
    before = [p.detach().clone() for p in pt.params]
    canvas, hs, ws, labels, weights = _batch(1)
    hb = HostBatch(canvas, hs, ws, labels, weights, [None] * len(hs))
    for _ in range(2):
        pt.train_batch(hb, stage, (1e-2, 1e-2, 1e-2))
    moved = {0: False, 1: False, 2: False}
    for p, b, lab, name in zip(pt.params, before, pt.labels, pt.names):
        if lab > stage:
            assert torch.equal(p.detach(), b), name
            assert float(pt.opt_state["mu"][pt.names.index(name)]
                         .abs().sum()) == 0.0
        else:
            moved[lab] |= not torch.equal(p.detach(), b)
    assert all(moved[g] for g in range(stage + 1))
    assert pt.opt_state["count"] == 2


def test_eval_matches_jax(jax_variables):
    jmodel, variables = jax_variables
    canvas, hs, ws, labels, weights = _batch(2, b=16)
    jt = jax_trainer.Trainer(jmodel, _copy(variables), optimizer="SGD",
                             preprocess_spec=JaxSpec(32, 32, 3, "mode"))
    jls, jc, jn, jp = jt.eval_batch(
        JaxHostBatch(canvas, hs, ws, labels, weights, [None] * 16))
    pt = port.Trainer(_port_model(variables), optimizer="SGD",
                      preprocess_spec=PreprocessSpec(32, 32, 3, "mode"),
                      device="cpu")
    pls, pc, pn, pp = pt.eval_batch(
        HostBatch(canvas, hs, ws, labels, weights, [None] * 16))
    assert float(pls) == pytest.approx(float(jls), rel=1e-5)
    assert float(pc) == float(jc) and float(pn) == float(jn)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))


@pytest.fixture(scope="module")
def mixed_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(11)
    paths, labels = [], []
    for i in range(21):
        h, w = int(rng.integers(10, 40)), int(rng.integers(12, 60))
        p = root / f"img_{i:03}.png"
        cv2.imwrite(str(p), rng.integers(0, 255, (h, w), np.uint8))
        paths.append(p)
        labels.append(i % 3)
    return paths, labels


def test_per_step_loop_equals_whole_epoch_call(jax_variables, mixed_paths):
    _, variables = jax_variables
    paths, labels = mixed_paths
    spec = PreprocessSpec(32, 32, 3, border="black")
    aug = dict(flip=True, translate=True, zoom=True, brightness=True,
               zoom_range=(0.8, 1.2), brightness_range=(0.95, 1.05))
    lrs = (1e-3, 1e-4, 1e-5)

    def setup():
        ds = DeviceDataset(paths, labels, spec, batch_size=8, seed=3,
                           shuffle=True, buckets=((24, 40), (64, 64)))
        t = port.Trainer(_port_model(variables), optimizer="Adam",
                         preprocess_spec=spec, augment_kwargs=aug, seed=4,
                         device="cpu")
        return ds, t

    ds1, t_loop = setup()
    assert len(ds1._bucket_keys) > 1
    loss = correct = n = 0.0
    for keys, idxs, weights in ds1.epoch_mixed(shuffle=True):
        ls, c, k = t_loop.train_batch_mixed(
            tuple(ds1.stores[key] for key in keys), idxs, weights, 2, lrs)
        loss += float(ls)
        correct += float(c)
        n += float(k)
    ds2, t_epoch = setup()
    ls, c, k = t_epoch.train_epoch_mixed(*ds2.epoch_mixed_stacked(True), 2,
                                         lrs)
    assert float(k) == n == len(paths)
    assert float(c) == correct
    assert float(ls) == pytest.approx(loss, rel=1e-6)
    for a, b in zip(t_loop.model.state_dict().values(),
                    t_epoch.model.state_dict().values()):
        assert torch.equal(a, b)
    # the generators advanced identically
    assert torch.equal(t_loop.gen.get_state(), t_epoch.gen.get_state())


def test_rotation_trains_and_unknown_optimizer_raises(jax_variables):
    _, variables = jax_variables
    t = port.Trainer(_port_model(variables), device="cpu",
                     preprocess_spec=PreprocessSpec(32, 32),
                     augment_kwargs=dict(flip=True, rotate=True,
                                         max_rotation=10), seed=1)
    canvas, hs, ws, labels, weights = _batch(3)
    before = resize_pad.launches
    loss, _, n = t.train_batch(
        HostBatch(canvas, hs, ws, labels, weights, [None] * len(hs)), 0,
        (1e-3, 0.0, 0.0))
    assert np.isfinite(float(loss)) and float(n) == float(weights.sum())
    assert resize_pad.launches == before  # the CPU takes the plain version
    with pytest.raises(ValueError):
        port.make_optimizer("lamb")
