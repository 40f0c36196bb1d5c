"""The ``prob`` command end to end: ``python -m sykepic_tpu_torch prob``'s
``main`` beside ``python -m sykepic_tpu prob``'s, in-process, on the fixture
raw directory. Both CSV trees hold the same files, header and roi column,
with values within 1.2e-5 (one 1e-5 quantum: the conv sums run in another
order, so a value near a rounding edge may print the neighbouring digit).

Also: the port's cv2-free INTER_LINEAR downscale (``pack.pre_shrink``) is
bit-exact against ``cv2.resize``.
"""

import numpy as np
import pytest
import torch

from sykepic_tpu.__main__ import main as jax_main
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.ingest import pack

RAW = "tests/data/raw/valid"
QUANTUM_BOUND = 1.2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _csvs(root):
    return {p.relative_to(root): p for p in sorted(root.rglob("*.csv"))}


def _read(path):
    lines = path.read_text().splitlines()
    rows = np.array([[float(v) for v in line.split(",")] for line in lines[1:]])
    return lines[0], rows


def test_prob_cli_matches_jax(tmp_path, model_dir):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    main(["prob", "-r", RAW, "-m", str(model_dir), "-o", str(mine),
          "-b", "4", "--device", "cpu"])
    jax_main(["prob", "-r", RAW, "-m", str(model_dir), "-o", str(theirs),
              "-b", "4"])
    got, want = _csvs(mine), _csvs(theirs)
    assert list(got) == list(want) and len(got) == 1
    for rel in got:
        assert str(rel).endswith(".prob.csv")
        gh, gr = _read(got[rel])
        wh, wr = _read(want[rel])
        assert gh == wh and gh.startswith("roi,")
        np.testing.assert_array_equal(gr[:, 0], wr[:, 0])
        assert np.abs(gr[:, 1:] - wr[:, 1:]).max() <= QUANTUM_BOUND
        np.testing.assert_allclose(gr[:, 1:].sum(1), 1.0, atol=1e-3)


def test_rerun_skips_unless_forced(tmp_path, model_dir):
    argv = ["prob", "-r", RAW, "-m", str(model_dir), "-o", str(tmp_path),
            "-b", "4", "--device", "cpu"]
    main(argv)
    (csv,) = _csvs(tmp_path).values()
    csv.write_text("marker\n")
    main(argv)  # exists: skipped
    assert csv.read_text() == "marker\n"
    main(argv + ["-f"])
    assert csv.read_text().startswith("roi,")


def test_image_inputs_name_their_slice(tmp_path, model_dir):
    # the image inputs are ported (held against JAX in
    # tests/test_torch_prob_images.py): a directory's PNGs group into
    # samples by name, one CSV each in the output directory itself
    from sykepic_tpu_torch.utils import png

    images = tmp_path / "images"
    images.mkdir()
    png.write_png(images / "D20200101T000000_IFCB1_00003.png",
                  np.full((20, 30), 120, np.uint8))
    out = tmp_path / "out"
    main(["prob", "--image-dir", str(images), "-m", str(model_dir),
          "-o", str(out), "--device", "cpu"])
    lines = (out / "D20200101T000000_IFCB1.prob.csv").read_text().splitlines()
    assert len(lines) == 2 and lines[1].startswith("3,")


def test_cuda_flag_without_card_raises(tmp_path, model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["prob", "-r", RAW, "-m", str(model_dir), "-o", str(tmp_path)])


@pytest.mark.parametrize("seed", range(4))
def test_pre_shrink_bit_exact_against_cv2(seed):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    mismatches = 0
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(181, 601, 2))
        if seed % 2:  # one axis within the target, the other over it
            h = int(rng.integers(20, 181))
        smooth = cv2.resize(rng.integers(0, 256, (h // 8 + 2, w // 8 + 2),
                                         np.uint8), (w, h))
        img = np.clip(smooth.astype(np.int16)
                      + rng.integers(-20, 21, (h, w)), 0, 255).astype(np.uint8)
        got = pack.pre_shrink(img, 180, 180)
        nh, nw = got.shape
        assert max(nh, nw) <= 180
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        mismatches += int((got != want).sum())
    assert mismatches == 0
