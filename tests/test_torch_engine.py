"""The slice as a whole: the port's ``Classifier(device="cpu")`` against the
JAX ``Classifier`` at full width (the ResNet18 of
``tests/model/resnet18_ref/config.ini``, 3x180x180, head 256,128, 50
classes) on the fixture sample, packed on shelves, with the wire codec on
and off.

Bounds: the same ROI ids, the same argmax, and probabilities within
1.2e-5, one 1e-5 quantum of the fixed-point rows (``__graft_entry__.py``'s
bound): conv sums run in another order, so a value near a rounding edge
may land on the neighbouring quantum. The codec is lossless, so both of
the port's codec settings are held against one JAX run.
"""

import os

import numpy as np
import pytest
import torch
from torch_model_dirs import family_model_dir

from sykepic_tpu.compute import engine as jengine
from sykepic_tpu.ingest import ifcb
from sykepic_tpu_torch.compute import engine
from sykepic_tpu_torch.ingest import shelf
from sykepic_tpu_torch.models import registry
from sykepic_tpu_torch.ops import preprocess, resize_pad
from sykepic_tpu_torch.utils import profiling

FIXTURE = "tests/data/raw/valid/D20180712T065600_IFCB114"
QUANTUM_BOUND = 1.2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _with_env(env: dict, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tagged():
    return [(0, rid, img) for rid, img in ifcb.read_sample(FIXTURE).images()]


def _classify(clf):
    return sorted((rid, p) for _, rid, p in clf.classify_rois(_tagged()))


@pytest.fixture(scope="module", params=["shelf"])
def jax_run(request, model_dir):
    # the JAX Classifier packs shelves unless told otherwise
    return _classify(jengine.Classifier(model_dir, batch_size=16))


@pytest.mark.parametrize("codec", ["on", "off"])
def test_classifier_matches_jax(jax_run, model_dir, codec):
    want = jax_run
    clf = _with_env({"SYKEPIC_WIRE_CODEC": codec},
                    lambda: engine.Classifier(model_dir, batch_size=16,
                                              device="cpu"))
    assert clf.device == torch.device("cpu")
    assert clf.wire_codec == (codec == "on")
    clf.timer = profiling.StageTimer(enabled=True)
    before = resize_pad.launches
    got = _classify(clf)
    assert resize_pad.launches == before  # the CPU takes the plain version
    assert [r for r, _ in got] == [r for r, _ in want]
    assert len(got) == 2  # ROI 1 of the fixture is an empty trigger
    gp = np.stack([p for _, p in got])
    wp = np.stack([np.asarray(p) for _, p in want])
    assert gp.shape == (2, 50) and np.isfinite(gp).all()
    np.testing.assert_array_equal(gp.argmax(1), wp.argmax(1))
    assert np.abs(gp - wp).max() <= QUANTUM_BOUND
    if codec == "on":
        assert clf.timer.totals["engine.wire_encoded"] >= 1


def _jax_rows(p):
    import jax

    return np.asarray(jax.jit(jengine._pack_probs_u16)(p))


@pytest.mark.parametrize("n_classes", [3, 16, 17, 50])
def test_pack_probs_u16_rows_bit_identical(n_classes):
    rng = np.random.default_rng(n_classes)
    rows = rng.dirichlet(np.full(n_classes, 0.3), size=64)
    edges = np.zeros((6, n_classes))
    edges[0, 0] = 1.0
    edges[1, 0] = 0.65536
    edges[1, -1] = 1.0 - 0.65536
    edges[2, 0] = 0.65535
    edges[3, 0] = np.nan
    edges[4, -1] = np.inf
    edges[5, 0] = 1.5  # clipped like the JAX rows
    edges[5, -1] = -0.25
    p = np.vstack([rows, edges]).astype(np.float32)
    got = engine._pack_probs_u16(torch.from_numpy(p))
    assert got.dtype == torch.int16
    want = _jax_rows(p)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    out = engine.unpack_probs_u16(got.numpy(), n_classes)
    ref = jengine.unpack_probs_u16(want, n_classes)
    np.testing.assert_array_equal(out, ref)
    assert np.isnan(out[-3, 0]) and np.isnan(out[-2, -1])


def test_zero_row_unpack():
    out = engine.unpack_probs_u16(np.zeros((0, 54), np.int16), 50)
    assert out.shape == (0, 50) and out.dtype == np.float32


def test_precompile_and_onchip_rate_on_cpu(model_dir):
    """precompile dispatches once per distinct shelf key, snapped onto
    the packer's ladders (two keys that snap alike warm one shape)."""
    clf = engine.Classifier(model_dir, batch_size=2, device="cpu")
    seen = []
    inner = clf.dispatch_shelf

    def spy(batch, meta=None):
        seen.append((batch.windows.shape[0], len(batch.win_idx)))
        return inner(batch, meta)

    clf.dispatch_shelf = spy
    assert clf.precompile([(1, 2), (1, 3)]) == 1
    assert seen == [(shelf.pad_nc(1), shelf.SLOT_MIN)]


def test_precompile_for_samples_warms_the_stream_shapes(model_dir):
    from sykepic_tpu_torch.compute import probability

    clf = engine.Classifier(model_dir, batch_size=2, device="cpu")
    shapes = {(b.windows.shape[0], len(b.win_idx))
              for b in clf._packed(iter(_tagged()))}
    assert probability.precompile_for_samples([FIXTURE], clf) == len(shapes)


def _family_dir(name, model_dir, root):
    """The file's ResNet18 directory, or a small one of another network."""
    if name == "resnet18":
        return model_dir
    return family_model_dir(root, name, size=64, head=(32, 16))


def _seeded_slots(clf, seed, b=2, ch=48, cw=96):
    """A seeded slot batch for ``clf._forward``: random canvases of ROIs
    up to 48x96 and their (10, b) metadata."""
    rng = np.random.default_rng(seed)
    hs, ws = rng.integers(8, ch + 1, b), rng.integers(8, cw + 1, b)
    canvas = rng.integers(0, 256, (b, ch, cw), dtype=np.uint8)
    geom = preprocess.compute_geometry(hs, ws, clf.spec.target_h,
                                       clf.spec.target_w)
    meta = preprocess.slot_meta(hs, ws, *geom, rng.integers(0, 256, b))
    return torch.from_numpy(canvas), torch.from_numpy(meta)


@pytest.mark.parametrize("name,dtype,want", [
    ("resnet18", "float32", torch.contiguous_format),
    ("vgg11", "float32", torch.contiguous_format),
    # grouped convolutions, none depthwise
    ("regnet_y_400mf", "float32", torch.contiguous_format),
    ("resnet18", "bfloat16", torch.channels_last),
    ("convnext_tiny", "float32", torch.channels_last),
    # depthwise convolutions
    ("efficientnet_b0", "float32", torch.channels_last),
])
def test_eval_memory_format_follows_dtype_and_layers(model_dir, tmp_path,
                                                     name, dtype, want):
    clf = engine.Classifier(_family_dir(name, model_dir, tmp_path),
                            batch_size=4, dtype=dtype, device="cpu")
    assert clf.memory_format == want
    weights = [p for p in clf.model.parameters() if p.dim() == 4]
    assert weights and all(p.is_contiguous(memory_format=want)
                           for p in weights)
    seen = []
    clf.model.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    with torch.inference_mode():
        clf._forward(*_seeded_slots(clf, 0))
    (x,) = seen
    assert x.is_contiguous(memory_format=want)


@pytest.mark.parametrize("name,dtype,want", [
    # depthwise convolutions
    ("mobilenet_v3_small", "float32", torch.channels_last),
    ("efficientnet_v2_s", "float32", torch.channels_last),
    ("alexnet", "float32", torch.contiguous_format),
    ("vgg16_bn", "float32", torch.contiguous_format),
    # grouped convolutions, none depthwise
    ("resnext50_32x4d", "float32", torch.contiguous_format),
    ("regnet_x_400mf", "float32", torch.contiguous_format),
    # NHWC blocks
    ("convnext_small", "float32", torch.channels_last),
    # bfloat16 runs channels_last whatever the layers
    ("resnet50", "bfloat16", torch.channels_last),
    ("vgg11", "bfloat16", torch.channels_last),
    ("efficientnet_b0", "bfloat16", torch.channels_last),
    ("mobilenet_v3_large", "bfloat16", torch.channels_last),
    ("convnext_tiny", "bfloat16", torch.channels_last),
])
def test_network_picks_its_eval_memory_format(name, dtype, want):
    """Each family's side of the layout rule, asked of the network itself
    (built on the meta device: no weights, no forward)."""
    with torch.device("meta"):
        model = registry.build_model(name, 50)
    assert model.eval_memory_format(engine._DTYPES[dtype]) == want


@pytest.mark.parametrize("name", ["resnet18", "efficientnet_b0"])
def test_probabilities_agree_across_memory_formats(tmp_path, name):
    """A float32 Classifier in the format it picks against the same
    weights run in the other format, on one seeded batch."""
    d = family_model_dir(tmp_path, name, size=64, head=(32, 16))
    clf = engine.Classifier(d, batch_size=4, device="cpu")
    other = engine.Classifier(d, batch_size=4, device="cpu")
    other.memory_format = (torch.channels_last if clf.memory_format
                           == torch.contiguous_format
                           else torch.contiguous_format)
    other.model = other.model.to(memory_format=other.memory_format)
    args = _seeded_slots(clf, 1, b=8)
    with torch.inference_mode():
        got, want = (engine.unpack_probs_u16(c._forward(*args).numpy(),
                                             len(c.classes))
                     for c in (clf, other))
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert np.abs(got - want).max() <= QUANTUM_BOUND
