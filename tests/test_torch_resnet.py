"""The port's ResNet (``sykepic_tpu_torch.models``) and checkpoint loading
against the JAX package, on the same weights.

Flax ``init_variables`` (seed 0) makes a resnet18 at a 32x32 input with 5
classes, head (16, 8) and a Dropout spliced at -1; ``from_flax_variables``
turns them into the port's weights. The eval forwards agree within
``rtol=1e-4, atol=1e-5``: both are float32, but the conv sums run in
another order (XLA CPU versus oneDNN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sykepic_tpu.models import convert_torch
from sykepic_tpu.models import registry as jregistry
from sykepic_tpu_torch.models import build_model, checkpoint

HEAD = (16, 8)
DROPOUT = ((-1, 0.5),)
NUM_CLASSES = 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flax_model():
    model = jregistry.build_model("resnet18", NUM_CLASSES, head=HEAD,
                                  dropout=DROPOUT)
    variables = jregistry.init_variables(model, (32, 32, 3), seed=0)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # random running statistics, so eval-mode BatchNorm is not the identity
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


def _port_model(state_dict):
    model = build_model("resnet18", NUM_CLASSES, head=HEAD, dropout=DROPOUT)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def test_eval_forward_matches_flax(flax_model):
    model, variables = flax_model
    x = np.random.default_rng(1).random((4, 32, 32, 3), np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    port = _port_model(checkpoint.from_flax_variables(variables, DROPOUT))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (4, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # channels_last storage (how the trainer and a bf16 engine run it)
    # changes nothing
    port = port.to(memory_format=torch.channels_last)
    with torch.inference_mode():
        got_cl = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_cl.numpy(), want, rtol=1e-4, atol=1e-5)


def test_head_places_dropout_at_reference_indices(flax_model):
    _, variables = flax_model
    sd = checkpoint.from_flax_variables(variables, DROPOUT)
    # [Linear, Linear, Dropout, Linear]: Linears at head.0, head.1, head.3
    assert sorted(k for k in sd if k.startswith("head.")) == [
        "head.0.bias", "head.0.weight", "head.1.bias", "head.1.weight",
        "head.3.bias", "head.3.weight"]
    port = _port_model(sd)
    assert isinstance(port.head[2], torch.nn.Dropout)


@pytest.mark.parametrize("n,dropout", [
    (3, ()), (3, ((-1, 0.5),)), (3, ((0, 0.2), (-2, 0.5))), (1, ((0, 0.1),)),
])
def test_head_linear_indices_match_jax(n, dropout):
    assert checkpoint.head_linear_indices(n, dropout) == \
        convert_torch._head_linear_indices(n, dropout)


def test_msgpack_reader_matches_flax(flax_model):
    _, variables = flax_model
    extra = {"scalar": np.float32(1.5), "ints": np.arange(7, dtype=np.int64),
             "text": "abc", "flag": True, "none": None, "neg": -3,
             "big": 2**40, "nested": {"list": [1, 2.5, "x"]},
             "bf16": jnp.arange(5, dtype=jnp.bfloat16)}
    data = serialization.msgpack_serialize({**variables, "extra": extra})
    want = serialization.msgpack_restore(data)
    got = checkpoint.msgpack_restore(data)

    def same(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys()
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (np.ndarray, np.generic)):
            np.testing.assert_array_equal(np.asarray(a, np.float64),
                                          np.asarray(b, np.float64))
            assert np.shape(a) == np.shape(b)
        else:
            assert a == b and type(a) is type(b)

    same(got, want)


def test_converted_pth_loads_strict(flax_model, tmp_path):
    """The JAX package's exporter writes the reference ``base.N``/``head.K``
    layout; after the key rules it loads strict, with the same weights."""
    _, variables = flax_model
    ref = convert_torch.flax_resnet_to_torch(variables, dropout=DROPOUT)
    assert any(k.startswith("base.") for k in ref)
    sd = checkpoint.normalize_state_dict(ref)
    _port_model(sd)  # strict
    mine = checkpoint.from_flax_variables(variables, DROPOUT)
    assert sd.keys() == mine.keys()
    for k in sd:
        torch.testing.assert_close(sd[k].to(mine[k].dtype), mine[k],
                                   atol=0, rtol=0)


def test_load_model_state_from_either_format(flax_model, tmp_path):
    _, variables = flax_model
    a = tmp_path / "msgpack"
    b = tmp_path / "pth"
    a.mkdir()
    b.mkdir()
    (a / checkpoint.BEST_STATE).write_bytes(
        serialization.msgpack_serialize(variables))
    torch.save(convert_torch.flax_resnet_to_torch(variables, DROPOUT),
               b / checkpoint.TORCH_STATE)
    sa = checkpoint.load_model_state(a, DROPOUT)
    sb = checkpoint.load_model_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sb[k].to(sa[k].dtype), sa[k], atol=0,
                                   rtol=0)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_model_state(tmp_path)


def test_registry_names_equal_jax():
    """The JAX registry's 50 names first, in its order, then the port's own
    Swin Transformers, which the JAX package lacks."""
    from sykepic_tpu_torch.models import MODEL_REGISTRY

    names = list(MODEL_REGISTRY)
    assert names[:50] == list(jregistry.MODEL_REGISTRY)
    assert len(jregistry.MODEL_REGISTRY) == 50
    assert names[50:] == ["swin_t", "swin_s", "swin_b"]


def test_other_families_build_and_unknown_names_raise():
    model = build_model("efficientnet_b0", 3)
    assert model.network == "efficientnet_b0"
    assert model.head[-1].out_features == 3
    with pytest.raises(ValueError):
        build_model("not_a_network", 3)


@pytest.mark.parametrize("name", ["resnet50", "resnext50_32x4d",
                                  "wide_resnet50_2"])
def test_bottleneck_families_have_torchvision_shapes(name):
    """Parameter counts of torchvision's constructors with this head."""
    counts = {"resnet50": 23_508_032, "resnext50_32x4d": 22_979_904,
              "wide_resnet50_2": 66_834_240}
    model = build_model(name, 10, head=(16,))
    head = 2048 * 16 + 16 + 16 * 10 + 10
    assert sum(p.numel() for p in model.parameters()) - head == counts[name]
