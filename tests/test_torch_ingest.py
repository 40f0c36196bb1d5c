"""The port's IFCB ingest and its helpers held to ``tests/test_ingest.py``
and ``tests/test_edge_cases.py``, each against the JAX package's function on
the same inputs: ``parse_adc``, ``read_sample``, ``raw_to_numpy``,
``raw_to_png`` (PNG bytes decoded equal), truncated samples,
``sample_to_datetime``, ``sample_volume``,
``filter_out_quality_flagged_samples``, ``sample_csv_path``,
``effective_batch_size``, ``target_resize_dims``, ``snap_dim`` and the slot
packer's streams, and zero-ROI samples through ``read_sample``, ``prob``,
``feat`` and ``pipeline --device-features`` (each file byte for byte equal
to the JAX package's). Tolerance: exact equality. The host shrink and the
oversized-ROI slot stream are held in ``tests/test_torch_pack.py``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from sykepic_tpu.ingest import ifcb as jifcb
from sykepic_tpu.ingest import pack as jpack
from sykepic_tpu.utils import files as jfiles
from sykepic_tpu_torch.ingest import ifcb, pack
from sykepic_tpu_torch.utils import files, png, timefmt

VALID = "tests/data/raw/valid/D20180712T065600_IFCB114"
EMPTY = "D20200101T120000_IFCB114"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_parse_adc_equals_jax():
    got = ifcb.parse_adc(VALID + ".adc")
    assert [a.tolist() for a in got] == [[0, 56, 128], [0, 42, 53],
                                        [0, 0, 2352]]
    for a, b in zip(got, jifcb.parse_adc(VALID + ".adc")):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_read_sample_equals_jax():
    rois, want = ifcb.read_sample(VALID), jifcb.read_sample(VALID)
    assert rois.sample == want.sample == "D20180712T065600_IFCB114"
    assert rois.roi_ids.tolist() == [2, 3]
    for f in ("roi_ids", "widths", "heights", "starts", "roi_data"):
        np.testing.assert_array_equal(getattr(rois, f), getattr(want, f))
    assert rois.image(0).shape == (42, 56) and rois.image(1).shape == (53, 128)
    assert rois.image(0).base is not None  # a view into the payload


def test_raw_to_numpy_equals_jax():
    got = list(ifcb.raw_to_numpy(VALID + ".adc", VALID + ".roi"))
    want = list(jifcb.raw_to_numpy(VALID + ".adc", VALID + ".roi"))
    assert [r for r, _ in got] == [r for r, _ in want] == [2, 3]
    payload = np.fromfile(VALID + ".roi", dtype=np.uint8)
    np.testing.assert_array_equal(got[0][1].ravel(), payload[:42 * 56])
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _one_row_sample(root: Path, w, h, start, payload_bytes) -> Path:
    sample = root / "D20990101T000000_IFCB999"
    cols = ["0"] * 18
    cols[15], cols[16], cols[17] = str(w), str(h), str(start)
    sample.with_suffix(".adc").write_text(",".join(cols) + "\n")
    np.zeros(payload_bytes, np.uint8).tofile(sample.with_suffix(".roi"))
    return sample


@pytest.mark.parametrize("start,payload", [(50, 60), (-10, 200)],
                         ids=["truncated", "negative_start"])
def test_faulty_sample_raises_valueerror_as_jax(tmp_path, start, payload):
    sample = _one_row_sample(tmp_path, 10, 10, start, payload)
    with pytest.raises(ValueError):
        jifcb.read_sample(sample)
    with pytest.raises(ValueError):
        ifcb.read_sample(sample)


def test_raw_to_png_decodes_equal_to_jax(tmp_path):
    import cv2

    ifcb.raw_to_png(VALID + ".adc", VALID + ".roi", out_dir=tmp_path / "port")
    jifcb.raw_to_png(VALID + ".adc", VALID + ".roi", out_dir=tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert names == ["D20180712T065600_IFCB114_00002.png",
                     "D20180712T065600_IFCB114_00003.png"]
    rois = ifcb.read_sample(VALID)
    for i, name in enumerate(names):
        ours = tmp_path / "port" / name
        np.testing.assert_array_equal(
            cv2.imread(str(ours), cv2.IMREAD_GRAYSCALE),
            cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(png.read_png(ours), rois.image(i))


def test_raw_to_png_refuses_an_existing_dir_without_force(tmp_path):
    out = tmp_path / "imgs"
    ifcb.raw_to_png(VALID + ".adc", VALID + ".roi", out_dir=out)
    with pytest.raises(FileExistsError):
        ifcb.raw_to_png(VALID + ".adc", VALID + ".roi", out_dir=out)
    ifcb.raw_to_png(VALID + ".adc", VALID + ".roi", out_dir=out, force=True)


@pytest.mark.parametrize("name", ["D20180703T093453_IFCB114",
                                  "D20211231T235959_IFCB999",
                                  "D20190101T000000_IFCB114"])
@pytest.mark.parametrize("iso", [False, True])
def test_sample_to_datetime_equals_jax(name, iso):
    got = timefmt.sample_to_datetime(name, isoformat=iso)
    assert got == jifcb.sample_to_datetime(name, isoformat=iso)
    assert ifcb.sample_to_datetime is timefmt.sample_to_datetime


@pytest.mark.parametrize("hdr", [None, "runTime: 1200\ninhibitTime: 18\n",
                                 "inhibitTime 3.5\nrunTime 61.25\n"])
def test_sample_volume_equals_jax(tmp_path, hdr):
    path = Path(VALID + ".hdr")
    if hdr is not None:
        path = tmp_path / "s.hdr"
        path.write_text(hdr.replace(":", ""))
    assert ifcb.sample_volume(path) == jifcb.sample_volume(path)
    if hdr is None:
        assert ifcb.sample_volume(path) == pytest.approx(0.985, rel=1e-3)


def test_nonpositive_sample_volume_raises(tmp_path):
    path = tmp_path / "s.hdr"
    path.write_text("runTime 10\ninhibitTime 10\n")
    with pytest.raises(ValueError):
        ifcb.sample_volume(path)
    with pytest.raises(ValueError):
        jifcb.sample_volume(path)


def test_filter_out_quality_flagged_samples_equals_jax(tmp_path):
    exc = tmp_path / "exclude.txt"
    exc.write_text("D20180712T065600\nD20190101T000000\n")
    paths = [VALID, "tests/data/raw/invalid/D20210523T053149_IFCB114",
             Path("/x/D20190101T000000_IFCB114")]
    kept = ifcb.filter_out_quality_flagged_samples(paths, exc)
    assert kept == jifcb.filter_out_quality_flagged_samples(paths, exc)
    assert [p.name for p in kept] == ["D20210523T053149_IFCB114"]


@pytest.mark.parametrize("suffix", [".prob", ".feat", ""])
def test_sample_csv_path_equals_jax(suffix):
    got = files.sample_csv_path(VALID, "/out", suffix=suffix)
    assert got == jfiles.sample_csv_path(VALID, "/out", suffix=suffix)
    if suffix == ".prob":
        assert str(got) == "/out/2018/07/12/D20180712T065600_IFCB114.prob.csv"


@pytest.mark.parametrize("multiple", [1, 3, 8])
def test_effective_batch_size_equals_jax(multiple):
    for batch in (1, 4, 72, 256, 512, 2048):
        for bucket in ((48, 64), (180, 180), (512, 512), (1024, 1024),
                       (1024, 960)):
            assert (pack.effective_batch_size(batch, bucket, multiple=multiple)
                    == jpack.effective_batch_size(batch, bucket,
                                                  multiple=multiple))
    if multiple == 8:
        assert pack.effective_batch_size(72, (1024, 1024), multiple=8) == 24


def test_target_resize_dims_equals_jax_and_device_geometry():
    from sykepic_tpu_torch.ops.preprocess import compute_geometry

    rng = np.random.default_rng(5)
    hs = np.concatenate([rng.integers(1, 600, 200), [180, 181, 179, 1, 11]])
    ws = np.concatenate([rng.integers(1, 600, 200), [180, 180, 180, 1, 33]])
    gh, gw, _, _ = compute_geometry(hs, ws, 180, 180)
    for h, w, eh, ew in zip(hs.tolist(), ws.tolist(), gh, gw):
        dims = pack.target_resize_dims(h, w, 180, 180)
        assert dims == jpack.target_resize_dims(h, w, 180, 180) == (eh, ew)
        # a fixed point: the device resize of a pre-shrunk ROI is identity
        assert pack.target_resize_dims(*dims, 180, 180) == dims


def test_snap_dim_equals_jax():
    for x in range(1, 1500):
        assert pack.snap_dim(x) == jpack.snap_dim(x)
    assert pack.snap_dim(5000) == pack.GRID_MAX


def _uniform(n, shape=(30, 50), sample=0):
    img = np.full(shape, 90, np.uint8)
    return [(sample, i + 1, img) for i in range(n)]


def _random_stream(seed, n):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 4)), i + 1,
             rng.integers(0, 256, (int(rng.integers(5, 300)),
                                   int(rng.integers(5, 400))), np.uint8))
            for i in range(n)]


def _consolidation_stream():
    rng = np.random.default_rng(9)
    out, rid = [], 0
    for h, w in [(25, 41), (30, 50), (33, 57), (40, 60), (45, 62)]:
        for _ in range(int(rng.integers(3, 9))):
            rid += 1
            out.append((0, rid, rng.integers(0, 256, (h, w), np.uint8)))
    return out


# name -> (stream, pack_rois keywords): the streams of tests/test_ingest.py
PACK_STREAMS = {
    "fixture": (lambda: [(0, r, im) for r, im in
                         ifcb.read_sample(VALID).images()],
                dict(batch_size=4)),
    "fixture_one_bucket": (lambda: [(0, r, im) for r, im in
                                    ifcb.read_sample(VALID).images()],
                           dict(batch_size=4, buckets=((64, 128),))),
    "tail_1200": (lambda: _uniform(1200), dict(batch_size=2048)),
    "tail_30": (lambda: _uniform(30), dict(batch_size=2048)),
    "multiple_8": (lambda: _uniform(10, (20, 20)),
                   dict(batch_size=64, batch_multiple=8)),
    "multiple_3_700": (lambda: _uniform(700),
                       dict(batch_size=2048, batch_multiple=3)),
    "multiple_3_95": (lambda: _uniform(95),
                      dict(batch_size=2048, batch_multiple=3)),
    "modes": (lambda: _random_stream(3, 5),
              dict(batch_size=8, compute_modes=True)),
    "consolidation": (_consolidation_stream, dict(batch_size=2048)),
    "random_64_x3": (lambda: _random_stream(17, 300),
                     dict(batch_size=64, batch_multiple=3,
                          compute_modes=True)),
    "pre_shrink": (lambda: _random_stream(21, 120),
                   dict(batch_size=256, pre_shrink_to=(180, 180))),
}


@pytest.mark.parametrize("name", sorted(PACK_STREAMS))
def test_pack_rois_equals_jax(name):
    make, kw = PACK_STREAMS[name]
    rois = make()
    got, want = list(pack.pack_rois(rois, **kw)), list(jpack.pack_rois(rois,
                                                                       **kw))
    assert len(got) == len(want)
    seen = []
    for g, w in zip(got, want):
        assert g.n_valid == w.n_valid
        np.testing.assert_array_equal(g.canvas, w.canvas)
        for f in ("heights", "widths", "roi_ids", "sample_idx", "modes"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        seen.extend(g.roi_ids[:g.n_valid].tolist())
        assert (g.roi_ids[g.n_valid:] == 0).all()
    assert sorted(seen) == sorted(r for _, r, _ in rois)


# -- zero-ROI samples (tests/test_edge_cases.py) ------------------------------

def make_empty_sample(raw_dir: Path) -> Path:
    """A sample whose adc rows are all empty triggers (w = h = 0)."""
    raw_dir.mkdir(parents=True, exist_ok=True)
    rows = "\n".join(",".join(["0"] * 24) for _ in range(3)) + "\n"
    (raw_dir / f"{EMPTY}.adc").write_text(rows)
    (raw_dir / f"{EMPTY}.roi").write_bytes(b"")
    (raw_dir / f"{EMPTY}.hdr").write_text("runTime: 60\ninhibitTime: 1\n")
    return raw_dir / EMPTY


def _only_csv(root: Path, suffix: str) -> Path:
    (csv,) = list(root.glob(f"**/*{suffix}.csv"))
    return csv


def test_zero_roi_sample_reads_empty(tmp_path):
    sample = make_empty_sample(tmp_path / "raw")
    rois = ifcb.read_sample(sample)
    assert len(rois) == 0 == len(jifcb.read_sample(sample))
    assert list(rois.images()) == []


def test_zero_roi_sample_prob_header_only_as_jax(tmp_path, model_dir):
    from sykepic_tpu.compute import probability as jprobability
    from sykepic_tpu_torch.compute import probability

    sample = make_empty_sample(tmp_path / "raw")
    written = probability.main([sample], model_dir, tmp_path / "port",
                               batch_size=4, progress_bar=False, device="cpu")
    assert written == {EMPTY}
    jprobability.main([sample], model_dir, tmp_path / "jax",
                      progress_bar=False, classifier=jprobability.prepare_model(
                          model_dir, batch_size=4))
    ours = _only_csv(tmp_path / "port", ".prob")
    lines = ours.read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith("roi,")
    assert ours.read_bytes() == _only_csv(tmp_path / "jax",
                                          ".prob").read_bytes()


def test_zero_roi_sample_feat_header_only_as_jax(tmp_path):
    from sykepic_tpu.compute import feature_native as jfeature_native
    from sykepic_tpu_torch.compute import feature_native

    sample = make_empty_sample(tmp_path / "raw")
    assert feature_native.process_sample(sample, tmp_path / "port") == EMPTY
    jfeature_native.process_sample(sample, tmp_path / "jax")
    ours = _only_csv(tmp_path / "port", ".feat")
    lines = ours.read_text().splitlines()
    assert len(lines) == 3 and lines[2].startswith("roi,")
    assert ours.read_bytes() == _only_csv(tmp_path / "jax",
                                          ".feat").read_bytes()


def test_zero_roi_sample_device_pipeline_header_only_as_jax(tmp_path,
                                                            model_dir):
    from sykepic_tpu.compute import pipeline as jpipeline
    from sykepic_tpu.compute import probability as jprobability
    from sykepic_tpu_torch.compute import pipeline, probability

    sample = make_empty_sample(tmp_path / "raw")
    clf = probability.prepare_model(model_dir, batch_size=4, device="cpu")
    done = pipeline.main([sample], clf, tmp_path / "port",
                         device_features=True)
    assert done == {EMPTY}
    jpipeline.main([sample], jprobability.prepare_model(model_dir,
                                                        batch_size=4),
                   tmp_path / "jax", device_features=True)
    for suffix, n_lines in ((".prob", 1), (".feat", 3)):
        ours = _only_csv(tmp_path / "port", suffix)
        assert len(ours.read_text().splitlines()) == n_lines, suffix
        assert ours.read_bytes() == _only_csv(tmp_path / "jax",
                                              suffix).read_bytes(), suffix
