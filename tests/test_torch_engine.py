"""The slice as a whole: the port's ``Classifier(device="cpu")`` against the
JAX ``Classifier`` at full width (the ResNet18 of
``tests/model/resnet18_ref/config.ini``, 3x180x180, head 256,128, 50
classes) on the fixture sample, for shelf and slot packing with the wire
codec on and off.

Bounds: the same ROI ids, the same argmax, and probabilities within
1.2e-5, one 1e-5 quantum of the fixed-point rows (``__graft_entry__.py``'s
bound): conv sums run in another order, so a value near a rounding edge
may land on the neighbouring quantum. The codec is lossless, so both of
the port's codec settings are held against one JAX run per packing.
"""

import os

import numpy as np
import pytest
import torch

from sykepic_tpu.compute import engine as jengine
from sykepic_tpu.ingest import ifcb
from sykepic_tpu_torch.compute import engine
from sykepic_tpu_torch.ops import resize_pad
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


@pytest.fixture(scope="module", params=["shelf", "slots"])
def jax_run(request, model_dir):
    packing = request.param
    res = _with_env({"SYKEPIC_PACKING": packing}, lambda: _classify(
        jengine.Classifier(model_dir, batch_size=16)))
    return packing, res


@pytest.mark.parametrize("codec", ["on", "off"])
def test_classifier_matches_jax(jax_run, model_dir, codec):
    packing, want = jax_run
    env = {"SYKEPIC_PACKING": packing, "SYKEPIC_WIRE_CODEC": codec}
    clf = _with_env(env, lambda: engine.Classifier(model_dir, batch_size=16,
                                                   device="cpu"))
    assert clf.device == torch.device("cpu")
    assert (clf.packing, clf.wire_codec) == (packing, codec == "on")
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
    if codec == "on" and packing == "shelf":
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


def test_f32_rows_when_compaction_off(model_dir):
    clf = _with_env({"SYKEPIC_D2H_COMPACT": "off",
                     "SYKEPIC_PACKING": "slots"},
                    lambda: engine.Classifier(model_dir, batch_size=4,
                                              device="cpu"))
    assert not clf.d2h_compact
    res = _classify(clf)
    p = np.stack([r[1] for r in res])
    assert p.dtype == np.float32
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-5)


def test_precompile_and_onchip_rate_on_cpu(model_dir):
    clf = _with_env({"SYKEPIC_PACKING": "slots"},
                    lambda: engine.Classifier(model_dir, batch_size=2,
                                              device="cpu"))
    assert clf.precompile([(2, 64, 128)]) == 1
    n, seconds = clf.onchip_rate(_tagged(), repeats=1)
    assert n == 2 and seconds > 0


def test_precompile_for_samples_warms_the_stream_shapes(model_dir):
    from sykepic_tpu_torch.compute import probability

    clf = _with_env({"SYKEPIC_PACKING": "slots"},
                    lambda: engine.Classifier(model_dir, batch_size=2,
                                              device="cpu"))
    shapes = {b.canvas.shape for b in clf._packed(iter(_tagged()))}
    assert probability.precompile_for_samples([FIXTURE], clf) == len(shapes)
