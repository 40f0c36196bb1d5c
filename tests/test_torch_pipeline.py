"""The slice as a whole: ``python -m sykepic_tpu_torch pipeline ...
--device-features --device cpu`` beside ``python -m sykepic_tpu pipeline ...
--device-features``, in-process, on the fixture sample plus one small
synthetic sample (three ROI sizes, one wider than the 180 px network input,
so the fused path's no-pre-shrink slots are exercised).

Bounds: the same sample set and ROI ids; ``.prob.csv`` within 1.2e-5 (one
1e-5 quantum) with the same argmax; ``.feat.csv`` with the JAX writer's
header lines and, over the ROIs with area >= 50, area, major and minor
identical (area equal, axes within 1e-5 relative) on >= 90%, at most 2
flips (area off by more than 20%), and biovolume within 1% at the 90th
percentile of the others (the ``device_features`` bounds of
``tests/test_torch_features_device.py``).
"""

import shutil

import numpy as np
import pytest
import torch

from sykepic_tpu.__main__ import main as jax_main
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.compute import engine
from sykepic_tpu_torch.ingest import ifcb
from sykepic_tpu_torch.ops import flood, resize_pad

FIXTURE = "tests/data/raw/valid/D20180712T065600_IFCB114"
QUANTUM_BOUND = 1.2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_sample(raw_dir, name, imgs):
    """One .adc/.roi/.hdr triplet (adc columns 15/16/17 = width/height/
    start byte)."""
    rows, payload, start = [], bytearray(), 0
    for img in imgs:
        h, w = img.shape
        cols = ["0"] * 24
        cols[15], cols[16], cols[17] = str(w), str(h), str(start)
        rows.append(",".join(cols))
        payload.extend(img.tobytes())
        start += h * w
    (raw_dir / f"{name}.adc").write_text("\n".join(rows) + "\n")
    (raw_dir / f"{name}.roi").write_bytes(bytes(payload))
    (raw_dir / f"{name}.hdr").write_text("runTime: 1200\ninhibitTime: 18\n")


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """The fixture sample and a synthetic one whose ROIs share the
    fixture's slot shapes (48x56, 56x128) or add one wider than 180 px
    (64x224): three canvas shapes, so three JAX compiles."""
    raw = tmp_path_factory.mktemp("raw")
    for suffix in (".adc", ".roi", ".hdr"):
        shutil.copy(f"{FIXTURE}{suffix}", raw)
    images = [img for _, img in ifcb.read_sample(FIXTURE).images()]
    rng = np.random.default_rng(3)
    imgs = []
    for h, w in ((42, 50), (50, 120), (60, 200), (45, 52), (55, 190)):
        src = images[len(imgs) % len(images)]
        ys = np.arange(h) * src.shape[0] // h
        xs = np.arange(w) * src.shape[1] // w
        noise = rng.integers(-3, 4, (h, w))
        imgs.append(np.clip(src[np.ix_(ys, xs)].astype(np.int16) + noise,
                            0, 255).astype(np.uint8))
    _write_sample(raw, "D20180712T070100_IFCB114", imgs)
    return raw


def _csvs(root, suffix):
    return {p.relative_to(root): p
            for p in sorted(root.rglob(f"*{suffix}.csv"))}


def _rows(path):
    lines = path.read_text().splitlines()
    body = [line for line in lines if not line.startswith("#")]
    return lines, np.array([[float(v) for v in line.split(",")]
                            for line in body[1:]])


@pytest.fixture(scope="module")
def both_runs(raw_dir, model_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    mine, theirs = out / "port", out / "jax"
    before = (resize_pad.launches, flood.warp_launches, flood.launches,
              flood.global_launches)
    written = main(["pipeline", "-r", str(raw_dir), "-m", str(model_dir),
                    "-o", str(mine), "-b", "4", "--device-features",
                    "--device", "cpu"])
    # the CPU takes the kernels' plain versions
    assert (resize_pad.launches, flood.warp_launches, flood.launches,
            flood.global_launches) == before
    jax_main(["pipeline", "-r", str(raw_dir), "-m", str(model_dir),
              "-o", str(theirs), "-b", "4", "--device-features"])
    return written, mine, theirs


def test_prob_csvs_match_jax(both_runs):
    written, mine, theirs = both_runs
    got, want = _csvs(mine, ".prob"), _csvs(theirs, ".prob")
    assert list(got) == list(want) and len(got) == 2
    assert written == {p.name.removesuffix(".prob.csv") for p in got}
    for rel in got:
        gl, gr = _rows(got[rel])
        wl, wr = _rows(want[rel])
        assert gl[0] == wl[0] and gl[0].startswith("roi,")
        np.testing.assert_array_equal(gr[:, 0], wr[:, 0])
        np.testing.assert_array_equal(gr[:, 1:].argmax(1), wr[:, 1:].argmax(1))
        assert np.abs(gr[:, 1:] - wr[:, 1:]).max() <= QUANTUM_BOUND


def test_feat_csvs_match_jax(both_runs):
    _, mine, theirs = both_runs
    got, want = _csvs(mine, ".feat"), _csvs(theirs, ".feat")
    assert list(got) == list(want) and len(got) == 2
    g_all, w_all = [], []
    for rel in got:
        gl, gr = _rows(got[rel])
        wl, wr = _rows(want[rel])
        assert gl[:3] == wl[:3]  # version, volume and column lines
        assert gl[0] == "# version=tpu-dev-v1"
        np.testing.assert_array_equal(gr[:, 0], wr[:, 0])  # roi-sorted ids
        assert (np.diff(gr[:, 0]) > 0).all()
        assert all(line.split(",")[4].isdigit() for line in gl[3:])
        g_all.append(gr)
        w_all.append(wr)
    g, w = np.concatenate(g_all), np.concatenate(w_all)
    assert g.shape == (7, 7) and np.isfinite(g).all()
    # columns: roi, biovolume_px, biovolume_um3, biomass_ugl, area, major,
    # minor
    checked = w[:, 4] >= 50
    assert checked.sum() >= 5
    g, w = g[checked], w[checked]
    flips = np.abs(g[:, 4] / w[:, 4] - 1) > 0.2
    same = ((g[:, 4] == w[:, 4]) & (np.abs(g[:, 5] / w[:, 5] - 1) <= 1e-5)
            & (np.abs(g[:, 6] / w[:, 6] - 1) <= 1e-5))
    assert same.sum() >= 0.9 * len(g) and flips.sum() <= 2
    assert np.percentile(np.abs(g[~flips, 1] / w[~flips, 1] - 1), 90) <= 0.01


def test_rerun_skips_unless_forced(raw_dir, model_dir, tmp_path):
    argv = ["pipeline", "-r", str(raw_dir), "-m", str(model_dir), "-o",
            str(tmp_path), "--feat-out", str(tmp_path / "feat"),
            "-b", "8", "--device-features", "--device", "cpu"]
    assert len(main(argv)) == 2
    assert len(_csvs(tmp_path / "feat", ".feat")) == 2
    assert main(argv) == set()  # both outputs exist: skipped
    assert len(main(argv + ["-f"])) == 2


def test_host_thread_mode_names_its_item(raw_dir, model_dir, tmp_path):
    """Without ``--device-features`` the host-thread mode runs (held
    against JAX in ``tests/test_torch_pipeline_host.py``): host features
    under their own version line."""
    assert len(main(["pipeline", "-r", str(raw_dir), "-m", str(model_dir),
                     "-o", str(tmp_path), "--device", "cpu"])) == 2
    feats = _csvs(tmp_path, ".feat")
    assert len(feats) == 2
    for path in feats.values():
        assert path.read_text().startswith("# version=tpu-v1\n")


def test_cuda_flag_without_card_raises(raw_dir, model_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["pipeline", "-r", str(raw_dir), "-m", str(model_dir), "-o",
              str(tmp_path), "--device-features"])


def test_fused_precompile_and_onchip_rate_on_cpu(model_dir):
    clf = engine.Classifier(model_dir, batch_size=2, device="cpu")
    # one slot shape: the classify dispatch and the feature program
    assert clf.precompile([(2, 48, 56)], fused=True) == 2
    tagged = [(0, rid, img)
              for rid, img in ifcb.read_sample(FIXTURE).images()]
    n, seconds = clf.fused_onchip_rate(tagged, repeats=1)
    assert n == 2 and seconds > 0
