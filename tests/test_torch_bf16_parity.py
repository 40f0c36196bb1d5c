"""The port's bfloat16 ``prob`` against its float32 ``prob`` on the CPU,
the contract of ``tests/test_bf16_parity.py``: bf16 never flips an argmax,
and with the JAX test's near-uniform weights (``bench.build_model_dir``'s
seeded Flax init, which the ``model_dir`` fixture also makes) the
probabilities drift under 5e-3. With ``chip_smoke.build_model_dir``'s seeded
He-normal weights (the card run's model) bf16 drifts further in both
packages; there the port's drift may exceed the JAX package's own drift on
the same ROIs by at most ``MARGIN``, and both stay under
``chip_smoke.BF16_DRIFT_BOUND``, the bound the card run holds bf16 to."""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from sykepic_tpu_torch.compute import probability
from sykepic_tpu_torch.ingest import ifcb, pack

FIXTURE = Path(__file__).parent / "data/raw/valid/D20180712T065600_IFCB114"
UNIFORM_DRIFT = 5e-3  # tests/test_bf16_parity.py's bound
MARGIN = 2e-3  # the port's bf16 drift over the JAX package's, He weights
N_ROIS = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sample(tmp_path_factory) -> Path:
    """``N_ROIS`` fixture ROIs area-resized to a spread of sizes (the
    synthetic sample of tests/test_bf16_parity.py; ``resize_area_u8`` is
    cv2's INTER_AREA), as a genuine .adc/.roi/.hdr triplet."""
    images = [img for _, img in ifcb.read_sample(FIXTURE).images()]
    rng = np.random.default_rng(3)
    imgs = []
    for i in range(N_ROIS):
        src = images[i % len(images)]
        w, h = int(rng.integers(40, 160)), int(rng.integers(24, 120))
        imgs.append(pack.resize_area_u8(src, min(h, src.shape[0]),
                                        min(w, src.shape[1])))
    root = tmp_path_factory.mktemp("bf16_raw")
    return chip_smoke.write_sample(root, "D20200101T000000_IFCB114", imgs)


def _read_prob_csv(out_dir: Path):
    (csv,) = list(out_dir.glob("**/*.csv"))
    lines = csv.read_text().splitlines()
    rows = np.array([[float(v) for v in line.split(",")]
                     for line in lines[1:]])
    return lines[0], rows[:, 0].astype(int).tolist(), rows[:, 1:]


def _port_probs(model_dir, sample_path, tmp_path):
    out = {}
    for dtype in ("float32", "bfloat16"):
        clf = probability.prepare_model(model_dir, batch_size=N_ROIS,
                                        dtype=dtype, device="cpu")
        probability.process_samples_batched([sample_path], clf,
                                            tmp_path / f"port_{dtype}")
        out[dtype] = _read_prob_csv(tmp_path / f"port_{dtype}")
    return out


def _jax_probs(model_dir, sample_path, tmp_path):
    from sykepic_tpu.compute import probability as jprobability

    out = {}
    for dtype in ("float32", "bfloat16"):
        clf = jprobability.prepare_model(model_dir, batch_size=N_ROIS,
                                         dtype=dtype)
        jprobability.process_samples_batched([sample_path], clf,
                                             tmp_path / f"jax_{dtype}")
        out[dtype] = _read_prob_csv(tmp_path / f"jax_{dtype}")
    return out


def _drift(res):
    (h32, rois32, p32), (h16, rois16, p16) = res["float32"], res["bfloat16"]
    assert h32 == h16 and rois32 == rois16
    return p32, p16, float(np.abs(p32 - p16).max())


def test_bf16_matches_f32_with_uniform_weights(model_dir, sample,
                                               tmp_path):
    p32, p16, drift = _drift(_port_probs(model_dir, sample, tmp_path))
    assert np.array_equal(p32.argmax(1), p16.argmax(1))
    assert drift < UNIFORM_DRIFT, drift


def test_bf16_fixture_argmax(model_dir, tmp_path):
    res = _port_probs(model_dir, FIXTURE, tmp_path)
    p32, p16, _ = _drift(res)
    assert res["float32"][1] == [2, 3]
    assert np.array_equal(p32.argmax(1), p16.argmax(1))


def test_bf16_drift_with_he_weights_within_jax_drift(sample, tmp_path):
    model_dir = chip_smoke.build_model_dir(tmp_path / "he")
    port = _port_probs(model_dir, sample, tmp_path)
    jax_res = _jax_probs(model_dir, sample, tmp_path)
    p32, p16, drift = _drift(port)
    j32, j16, jax_drift = _drift(jax_res)
    # the two packages' float32 runs agree within one 1e-5 quantum
    assert float(np.abs(p32 - j32).max()) <= chip_smoke.PROB_BOUND
    # the contract chip_smoke.py holds the card to: the argmax of every ROI
    # whose f32 top-two gap exceeds twice the bound, and the drift bound
    top2 = np.sort(p32, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * chip_smoke.BF16_DRIFT_BOUND
    assert (p32.argmax(1) == p16.argmax(1))[clear].all()
    assert (j32.argmax(1) == j16.argmax(1))[clear].all()
    assert jax_drift <= chip_smoke.BF16_DRIFT_BOUND, jax_drift
    assert drift <= chip_smoke.BF16_DRIFT_BOUND, drift
    assert drift <= jax_drift + MARGIN, (drift, jax_drift)
