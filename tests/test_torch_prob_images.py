"""``prob``'s image inputs (``--image-dir``, ``--images``) in the port
against the JAX package (``sykepic_tpu/compute/probability.py:42-47,102,
331-362``): gray, RGB and RGBA PNGs written by cv2 go through both
packages' ``prob`` in-process (the port with ``--device cpu``); the CSVs
hold the same files, ROI ids and argmax, with values within 1.2e-5 (one
1e-5 quantum). The samples group by ``name.rpartition("_")[0]``, the ROI
id is the stem's last ``_`` field, and each sample's CSV lands in the
output directory itself.

The colour rule is ``cv2.cvtColor(BGR2GRAY)``'s, not training's
``IMREAD_GRAYSCALE``: ``utils/png.py``'s ``gray="cvtcolor"`` mode equals
cv2 on every pixel of random 3- and 4-channel images, while the imread mode
stays as it was (``tests/test_torch_png.py``).
"""

import cv2
import numpy as np
import pytest
import torch

from sykepic_tpu.__main__ import main as jax_main
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.compute import probability
from sykepic_tpu_torch.ingest import ifcb
from sykepic_tpu_torch.utils import png

FIXTURE = "tests/data/raw/valid/D20180712T065600_IFCB114"
QUANTUM_BOUND = 1.2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("chans", [3, 4])
def test_cvtcolor_mode_equals_cv2(tmp_path, chans):
    rng = np.random.default_rng(chans)
    for h, w in ((1, 1), (37, 61), (180, 97)):
        img = rng.integers(0, 256, (h, w, chans), dtype=np.uint8)
        path = tmp_path / f"c{chans}_{h}x{w}.png"
        assert cv2.imwrite(str(path), img)
        want = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_UNCHANGED),
                            cv2.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(png.read_png(path, gray="cvtcolor"),
                                      want)
        # the training mode is libpng's, which differs on random colour
        assert np.array_equal(png.read_png(path),
                              cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Two samples of loose PNGs: the fixture's ROIs as gray, RGB (blue
    moved off green and red, so the luma weights matter and the grayscale
    check warns) and RGBA files, plus ROIs resampled to other sizes."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(7)
    rois = [img for _, img in ifcb.read_sample(FIXTURE).images()]
    n = 0
    for sample in ("D20200101T000000_IFCB1", "D20200102T000000_IFCB1"):
        for kind in ("gray", "rgb", "rgba"):
            for img in rois:
                for scale in (1.0, 0.6):
                    h = max(int(img.shape[0] * scale), 1)
                    w = max(int(img.shape[1] * scale), 1)
                    g = cv2.resize(img, (w, h))
                    n += 1
                    path = root / f"{sample}_{n:05}.png"
                    if kind == "gray":
                        out = g
                    else:
                        out = np.stack([g, g, g], axis=-1)
                        out[..., 0] = np.clip(
                            g.astype(int) + rng.integers(-40, 40, g.shape),
                            0, 255)
                        if kind == "rgba":
                            alpha = rng.integers(0, 256, g.shape, np.uint8)
                            out = np.concatenate([out, alpha[..., None]],
                                                 axis=-1)
                    assert cv2.imwrite(str(path), out)
    return root


def _read(path):
    lines = path.read_text().splitlines()
    return lines[0], np.array([[float(v) for v in line.split(",")]
                               for line in lines[1:]])


def _compare(mine, theirs):
    got = {p.name: p for p in mine.glob("*.csv")}
    want = {p.name: p for p in theirs.glob("*.csv")}
    assert sorted(got) == sorted(want) and len(got) == 2
    for name in got:
        gh, gr = _read(got[name])
        wh, wr = _read(want[name])
        assert gh == wh and len(gr) == len(wr) == 12
        np.testing.assert_array_equal(gr[:, 0], wr[:, 0])
        np.testing.assert_array_equal(gr[:, 1:].argmax(1),
                                      wr[:, 1:].argmax(1))
        assert np.abs(gr[:, 1:] - wr[:, 1:]).max() <= QUANTUM_BOUND


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory, image_dir, model_dir):
    """The JAX package's ``prob --image-dir`` on the set (``--images``
    with every file gives the same CSVs)."""
    out = tmp_path_factory.mktemp("jax")
    jax_main(["prob", "--image-dir", str(image_dir), "-m", str(model_dir),
              "-o", str(out), "-b", "8"])
    return out


def test_image_dir_matches_jax(tmp_path, image_dir, model_dir, jax_out):
    mine = tmp_path / "port"
    main(["prob", "--image-dir", str(image_dir), "-m", str(model_dir),
          "-o", str(mine), "-b", "8", "--device", "cpu"])
    _compare(mine, jax_out)


def test_images_list_matches_jax_and_force(tmp_path, image_dir, model_dir,
                                           jax_out, caplog):
    files = [str(p) for p in sorted(image_dir.glob("*.png"))]
    mine = tmp_path / "port"
    argv = ["prob", "--images", *files, "-m", str(model_dir), "-o",
            str(mine), "-b", "8", "--device", "cpu"]
    main(argv)
    # the colour files warn as JAX's do
    assert "is not grayscale; using luminance" in caplog.text
    _compare(mine, jax_out)
    # a rerun skips, --force rewrites
    csv = sorted(mine.glob("*.csv"))[0]
    csv.write_text("stale\n")
    main(argv)
    assert csv.read_text() == "stale\n"
    main(argv + ["--force"])
    assert csv.read_text().startswith("roi,")


def test_unreadable_image_is_skipped(tmp_path, image_dir, model_dir):
    files = sorted(image_dir.glob("D20200101T000000_IFCB1_*.png"))[:3]
    bad = tmp_path / "D20200101T000000_IFCB1_99999.png"
    bad.write_bytes(b"not a png")
    clf = probability.prepare_model(model_dir, batch_size=4, device="cpu")
    out = tmp_path / "x.prob.csv"
    probability.process_images([*files, bad], clf, out)
    _, rows = _read(out)
    assert [int(r) for r in rows[:, 0]] == [
        int(p.stem.split("_")[-1]) for p in files]
