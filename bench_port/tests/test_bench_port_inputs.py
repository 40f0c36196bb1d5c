"""The inputs made from the seed, and the plain reference against itself."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from bench_port import gen
from bench_port.reference import ifcb, preprocess
from bench_port.reference import train as ref_train
from bench_port.tests.tiny import SEED, tiny_plan

POOL = tiny_plan("resnet18.prob.archive")["traffic"]["pool"]
SET = tiny_plan("resnet18.train.steady")["traffic"]["set"]


def _pool_bytes(tmp, seed):
    pool = gen.build_pool(tmp, POOL, seed)
    return [(s["path"].with_suffix(".adc").read_bytes(),
             s["path"].with_suffix(".roi").read_bytes()) for s in pool], pool


def test_pool_repeats_per_seed_and_keeps_its_work(tmp_path):
    a, pa = _pool_bytes(tmp_path / "a", SEED)
    b, _ = _pool_bytes(tmp_path / "b", SEED)
    c, pc = _pool_bytes(tmp_path / "c", SEED + 1)
    assert a == b
    assert a != c
    # another seed: every sample keeps its ROI count and multiset of
    # shapes, in another order
    for x, y in zip(pa, pc):
        assert sorted(map(tuple, x["shapes"])) == sorted(map(tuple,
                                                             y["shapes"]))
    assert any(not np.array_equal(x["shapes"], y["shapes"])
               for x, y in zip(pa, pc))


def test_pool_decodes_to_its_shapes(tmp_path):
    pool = gen.build_pool(tmp_path, POOL, SEED)
    for s in pool:
        rois = ifcb.read_sample(s["path"])
        assert [im.shape for _, im in rois] == [tuple(x) for x in s["shapes"]]
        ids = [rid for rid, _ in rois]
        assert ids == sorted(set(ids)) and ids[0] >= 1


def test_train_set_repeats_per_seed():
    ia, la = gen.build_train_set(SET, SEED)
    ib, lb = gen.build_train_set(SET, SEED)
    ic, lc = gen.build_train_set(SET, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(ia, ib))
    assert np.array_equal(la, lb) and np.array_equal(la, lc)
    assert [x.shape for x in ia] == [x.shape for x in ic]
    assert not all(np.array_equal(x, y) for x, y in zip(ia, ic))


def test_weights_repeat_per_seed():
    net = importlib.import_module("bench_port.reference.nets.resnet18")
    cfg = tiny_plan("resnet18.prob.archive")["cfg"]
    rois, _ = gen.build_train_set(SET, SEED)
    a = gen.make_weights(net, cfg, SEED, "cpu", rois)
    b = gen.make_weights(net, cfg, SEED, "cpu", rois)
    assert all(torch.equal(a[k], b[k]) for k in a)
    images = preprocess.preprocess(rois[:cfg["calibration_rois"]], 32, 3,
                                   "cpu")
    with torch.no_grad():
        std = float(net.forward(a, images, cfg).std())
    assert std == pytest.approx(cfg["logit_std"], rel=1e-3)


@pytest.mark.parametrize("network", ["resnet18", "efficientnet_b0"])
def test_reference_forward_is_per_image(network):
    """A batch gives each image what it gives that image alone."""
    net = importlib.import_module(f"bench_port.reference.nets.{network}")
    cfg = tiny_plan("resnet18.prob.archive")["cfg"]
    rois, _ = gen.build_train_set(SET, SEED)
    p = gen.make_weights(net, cfg, SEED, "cpu", rois)
    x = preprocess.preprocess(rois[:6], 32, 3, "cpu")
    with torch.no_grad():
        whole = net.forward(p, x, cfg)
        alone = torch.cat([net.forward(p, x[i:i + 1], cfg) for i in range(6)])
    # float32 sums in another order: within a thousandth of the logits'
    # scale
    assert torch.allclose(whole, alone, rtol=0,
                          atol=1e-3 * float(whole.abs().max()))


def test_reference_preprocess_geometry():
    """A 30x60 ROI whose columns rise 0, 4, ..., 236 fills a centred
    90x180 band, ending on its last column's level; the rest takes the
    border, its mode (0: every level ties, the lowest wins). A ROI larger
    than the input is shrunk first."""
    img = np.tile(np.arange(60, dtype=np.uint8) * 4, (30, 1))
    out = preprocess.preprocess([img], 180, 3, "cpu")[0] * 255
    assert out.shape == (3, 180, 180)
    assert torch.all(out[:, :45] == 0) and torch.all(out[:, 135:] == 0)
    assert torch.allclose(out[:, 45:135, -1], torch.tensor(236.0))
    assert torch.all(out[:, 45:135, 0] == 0)
    assert preprocess.as_shipped(np.zeros((200, 400), np.uint8),
                                 180).shape == (90, 180)


def test_reference_train_steps_repeat():
    net = importlib.import_module("bench_port.reference.nets.resnet18")
    cfg = tiny_plan("resnet18.train.steady")["cfg"]
    images, labels = gen.build_train_set(SET, SEED)
    params = gen.make_weights(net, cfg, SEED, "cpu", images)
    aug = {"flip": True, "translate": True, "zoom": True,
           "brightness": True, "zoom_range": (0.6, 1.4),
           "brightness_range": (0.95, 1.1)}
    runs = []
    for _ in range(2):
        steps = ref_train.Steps(params, net, cfg, aug, (1e-3, 1e-3, 1e-3),
                                SEED, "cpu")
        losses = [steps.step([(images[:8], labels[:8]),
                              (images[8:16], labels[8:16])],
                             np.ones(16, np.float32))[0] for _ in range(2)]
        runs.append((losses, steps.params["conv1.weight"].clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][1], params["conv1.weight"])
