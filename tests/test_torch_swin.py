"""Swin Transformer in the port, on the CPU: its sizes and key layout; its
forward against the benchmark's plain reference
(``bench_port/reference/nets/swin_t.py``, explicit products, no SDPA, no
kernel of the port) on seeded weights; the reference-layout checkpoint
through ``prob``; the engine's window counters; and the Flax and export
paths refusing it.

The forward comparison runs a small Swin (C 16, heads 2/2/4/4, depths
2/2/2/2, window 7) at 36, 44 and 56 px: the token maps are 9/5/3/2, 11/6/3/2
and 14/7/4/2, so some windows are padded (9 -> 14, 11 -> 14, 4 -> 7), some
merges odd (9 -> 5, 5 -> 3, 11 -> 6, 7 -> 4), stage 1 is shifted at every
size and from stage 2 on (36, 44) or stage 3 on (56) the padded map equals
the window and the shift is dropped. ``LOGIT_TOL``: the port's logits within
2e-5 of their spread of the reference's, float32 throughout with the sums
in another order (SDPA against explicit products, ATen's LayerNorm on both
sides; 1.3e-6 to 4.6e-6 of the spread seen, the rest room for other CPUs'
kernels). A reference whose region mask is removed (0.049 to 0.66 of the
spread), or which masks the padded keys (2.4 to 2.5), falls outside it by
ten times and more, so the comparison cannot pass with either semantics
wrong.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import gen
from bench_port.reference import ifcb as ref_ifcb
from bench_port.reference import prob as ref_prob
from bench_port.reference.nets import swin_t as ref_net
from sykepic_tpu_torch.models import checkpoint, export, registry, swin
from sykepic_tpu_torch.ops import layernorm

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"embed_dim": 16, "depths": [2, 2, 2, 2], "heads": [2, 2, 4, 4],
         "window": 7}
SIZES = (36, 44, 56)
LOGIT_TOL = 2e-5
SEED = 2**31 + 29
# probabilities as a .prob.csv holds them: one 1e-5 quantum, and float32
# rounding (tests/test_torch_probability.py)
QUANTUM_BOUND = 1.2e-5
# torchvision's counts, less its 1000-class head
BACKBONE_PARAMS = {"swin_t": 27_519_354, "swin_s": 48_837_258,
                   "swin_b": 86_743_224}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _small(size: int):
    """A small Swin of the port, the reference's configuration for it and
    seeded weights of the reference's rule loaded into the port."""
    cfg = {"image_shape": [3, size, size], "head": [32, 16],
           "num_classes": 10, "logit_std": 8.0, "calibration_rois": 32,
           "swin": SMALL}
    params = gen.make_weights(ref_net, cfg, SEED, torch.device("cpu"),
                              gen.fixture_images())
    model = swin.SwinTransformer(SMALL["embed_dim"], SMALL["depths"],
                                 SMALL["heads"], 0.0, 10, head=(32, 16))
    model.load_state_dict(checkpoint.normalize_state_dict(params, "swin_t"),
                          strict=True)
    return model.eval().to(memory_format=torch.channels_last), cfg, params


def _images(size: int):
    x = torch.rand((8, 3, size, size),
                   generator=torch.Generator().manual_seed(size))
    return x.contiguous(memory_format=torch.channels_last)


def _gap(got, want) -> float:
    return float((got - want).abs().max()) / float(want.std())


@pytest.mark.parametrize("name", sorted(BACKBONE_PARAMS))
def test_published_sizes_in_torchvision_keys(name):
    with torch.device("meta"):
        model = registry.build_model(name, 50)
    params = dict(model.named_parameters())
    assert sum(p.numel() for k, p in params.items()
               if not k.startswith("head.")) == BACKBONE_PARAMS[name]
    keys = set(model.state_dict())
    for key in ("features.0.0.weight", "features.0.2.bias",
                "features.1.0.norm1.weight", "features.1.1.attn.qkv.weight",
                "features.1.1.attn.proj.bias",
                "features.1.1.attn.relative_position_bias_table",
                "features.1.1.attn.relative_position_index",
                "features.1.1.norm2.bias", "features.1.1.mlp.0.weight",
                "features.1.1.mlp.3.bias", "features.2.reduction.weight",
                "features.2.norm.weight", "features.7.1.mlp.3.weight",
                "norm.weight", "head.0.weight"):
        assert key in keys, key
    assert "features.2.reduction.bias" not in keys
    assert model.eval_memory_format(torch.float32) == torch.channels_last


def test_dispatch_counts_at_the_station_size():
    """180 px: maps 45/23/12/6 padded to 49/28/14/7; per ROI 156 windows,
    7,644 query tokens, 1,600 of them padding (20.9%)."""
    with torch.device("meta"):
        model = registry.build_model("swin_t", 50)
    assert model.dispatch_counts(180, 180) == {
        "swin.windows": 2 * 49 + 2 * 16 + 6 * 4 + 2 * 1,
        "swin.tokens": 7644, "swin.pad_tokens": 1600}
    with torch.device("meta"):
        other = registry.build_model("convnext_tiny", 50)
    assert other.dispatch_counts(180, 180) == {}


@pytest.mark.parametrize("size", SIZES)
def test_port_matches_the_plain_reference(size):
    model, cfg, params = _small(size)
    x = _images(size)
    n0 = layernorm.launches
    with torch.no_grad():
        want = ref_net.forward(params, x, cfg)
        got = model(x)
    assert _gap(got, want) <= LOGIT_TOL
    assert layernorm.launches == n0  # no kernel on the CPU


def _no_region_mask(*args):
    return None


def _pad_keys_masked(h, w, pad_h, pad_w, window, shift_h, shift_w, device,
                     real=ref_net.window_mask):
    """torchvision's mask plus minus infinity at every padded key."""
    pad = torch.ones(pad_h, pad_w, dtype=torch.bool, device=device)
    pad[:h, :w] = False
    pad = torch.roll(pad, (-shift_h, -shift_w), (0, 1))
    pad = pad.view(pad_h // window, window, pad_w // window, window)
    pad = pad.permute(0, 2, 1, 3).reshape(-1, 1, window * window)
    keys = torch.zeros(pad.shape, device=device).masked_fill(pad,
                                                             float("-inf"))
    base = real(h, w, pad_h, pad_w, window, shift_h, shift_w, device)
    return keys.expand(-1, window * window, -1) if base is None else base + keys


@pytest.mark.parametrize("variant", [_no_region_mask, _pad_keys_masked])
@pytest.mark.parametrize("size", SIZES)
def test_other_semantics_fail_the_tolerance(size, variant, monkeypatch):
    model, cfg, params = _small(size)
    x = _images(size)
    monkeypatch.setattr(ref_net, "window_mask", variant)
    with torch.no_grad():
        wrong = ref_net.forward(params, x, cfg)
        got = model(x)
    assert _gap(got, wrong) > 10 * LOGIT_TOL


# ---------------------------------------------------------------------------
# the reference layout through the checkpoint loader and prob
# ---------------------------------------------------------------------------

TINY = 32


@pytest.fixture(scope="module")
def swin_dir(tmp_path_factory):
    """A Swin-T model directory at 32 px whose ``best_state.pth`` holds the
    reference's ``base.0.*`` / ``base.1.*`` / ``head.K.*`` keys and no index
    buffers, one sample of about 50 ROIs, the reference configuration and
    the weights."""
    root = tmp_path_factory.mktemp("swin")
    cfg = json.loads((ROOT / "bench_port" / "configs" / "swin_t.json")
                     .read_text())
    cfg["image_shape"] = [3, TINY, TINY]
    cfg["ini"]["image"]["shape"] = f"3, {TINY}, {TINY}"
    cfg["calibration_rois"] = 32
    traffic = json.loads((ROOT / "bench_port" / "traffic" /
                          "prob_archive.json").read_text())
    traffic["pool"].update(samples=1, rois_per_sample=[40, 60])
    pool = gen.build_pool(root / "raw", traffic["pool"], SEED)
    images = [img for _, img in ref_ifcb.read_sample(pool[0]["path"])]
    params = gen.make_weights(ref_net, cfg, SEED, torch.device("cpu"), images)
    model_dir = gen.write_model_dir(root / "model", cfg, None)
    torch.save(_reference_layout(params), model_dir / checkpoint.TORCH_STATE)
    return model_dir, pool[0]["path"], cfg, params


def _reference_layout(params: dict, index: bool = False) -> dict:
    """The reference's keys: ``features`` is ``base.0``, ``norm``
    ``base.1``; with ``index`` torchvision's index buffers too."""
    out = {}
    for k, v in params.items():
        for child, base in (("features.", "base.0."), ("norm.", "base.1.")):
            if k.startswith(child):
                k = base + k.removeprefix(child)
        out[k] = v
        if index and k.endswith("relative_position_bias_table"):
            out[k.removesuffix("bias_table") + "index"] = \
                ref_net.relative_position_index(7)
    return out


@pytest.mark.parametrize("index", [False, True])
def test_reference_pth_loads(swin_dir, tmp_path, index):
    model_dir, _, _, params = swin_dir
    path = tmp_path / "best_state.pth"
    torch.save(_reference_layout(params, index), path)
    sd = checkpoint.normalize_state_dict(
        torch.load(path, weights_only=True))  # the family from the keys
    model = registry.build_model("swin_t", 50)
    model.load_state_dict(sd, strict=True)
    for k, v in params.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    assert torch.equal(model.features[5][3].attn.relative_position_index,
                       ref_net.relative_position_index(7))


def test_wrong_index_raises(swin_dir):
    _, _, _, params = swin_dir
    sd = _reference_layout(params, index=True)
    key = "base.0.3.1.attn.relative_position_index"
    sd[key] = sd[key].flip(0)
    with pytest.raises(ValueError, match="relative position index"):
        checkpoint.normalize_state_dict(sd, "swin_t")


def test_prob_rows_match_the_reference(swin_dir, tmp_path):
    """``prob --device cpu`` on the reference-layout directory (through
    ``prepare_model``) writes a ``.prob.csv`` whose rows are the plain
    reference's probabilities."""
    from sykepic_tpu_torch.__main__ import main

    model_dir, sample, cfg, params = swin_dir
    raw = tmp_path / "raw"
    raw.mkdir()
    for f in sample.parent.glob(sample.name + ".*"):
        shutil.copy(f, raw)
    assert main(["prob", "-r", str(raw), "-m", str(model_dir), "-o",
                 str(tmp_path / "out"), "-b", "64", "--device", "cpu"]) in (
        0, None)
    (csv,) = (tmp_path / "out").rglob("*.prob.csv")
    lines = csv.read_text().splitlines()
    assert lines[0] == "roi," + ",".join(cfg["class_names"])
    decoded = ref_ifcb.read_sample(sample)
    got = np.array([[float(v) for v in line.split(",")] for line in lines[1:]])
    assert [int(r) for r in got[:, 0]] == [rid for rid, _ in decoded]
    want = ref_prob.probabilities([img for _, img in decoded], params,
                                  ref_net, cfg, torch.device("cpu"))
    assert np.abs(got[:, 1:] - want).max() <= QUANTUM_BOUND


def test_engine_counts_windows_per_dispatch(swin_dir):
    from sykepic_tpu_torch.compute import probability
    from sykepic_tpu_torch.utils.profiling import StageTimer

    model_dir, sample, _, _ = swin_dir
    clf = probability.prepare_model(model_dir, batch_size=64, device="cpu")
    clf.timer = StageTimer(enabled=True)
    rois = ref_ifcb.read_sample(sample)
    rows = list(clf.classify_rois((0, rid, img) for rid, img in rois))
    assert len(rows) == len(rois)
    per_slot = clf.model.dispatch_counts(TINY, TINY)
    totals = clf.timer.totals
    assert totals["engine.slots"] >= len(rois)
    for name in ("swin.windows", "swin.tokens", "swin.pad_tokens"):
        assert totals[name] == per_slot[name] * totals["engine.slots"]
    # 32 px: maps 8/4/2/1 padded to 14/7/7/7, under 2/2/6/2 blocks
    assert per_slot == {"swin.windows": 2 * 4 + 2 + 6 + 2,
                        "swin.tokens": 18 * 49,
                        "swin.pad_tokens": 2 * (196 - 64) + 2 * (49 - 16)
                        + 6 * (49 - 4) + 2 * (49 - 1)}


def _flax_tree():
    return {"params": {"features_1_0_attn": {
        "relative_position_bias_table": np.zeros((169, 3), np.float32)}},
        "batch_stats": {}}


@pytest.mark.parametrize("path", ["from_flax", "to_flax", "sniff", "export"])
def test_flax_paths_refuse_swin(swin_dir, path):
    model_dir, _, _, params = swin_dir
    call = {
        "from_flax": lambda: checkpoint.from_flax_variables(
            _flax_tree(), network="swin_t"),
        "to_flax": lambda: checkpoint.to_flax_variables(
            checkpoint.normalize_state_dict(params, "swin_t")),
        "sniff": lambda: checkpoint.sniff_network(_flax_tree()),
        "export": lambda: export.export(model_dir, model_dir / "out.pth"),
    }[path]
    with pytest.raises(ValueError, match="no Flax form"):
        call()
