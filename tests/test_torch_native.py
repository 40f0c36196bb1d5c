"""The port's native host library (``sykepic_tpu_torch/ingest/native``)
held to ``tests/test_native.py`` and ``tests/test_adc_fuzz.py``: the ADC
parser against a Python parser and the port's NumPy twin on the fixture,
synthetic line endings and seeded fuzz; malformed samples raising
``ValueError``; the CSV row formatter and ``probabilities_to_csv`` byte for
byte equal to the JAX package's. Tolerance: exact equality.

Each native case requires the port's library (a failed build fails it);
each twin run patches ``native.lib`` to return None. The JAX side may run on
its own library or its twin; only outputs are compared. ``png_unfilter`` is
held against its twin in ``tests/test_torch_png.py``."""

from pathlib import Path

import numpy as np
import pytest

from sykepic_tpu.compute import probability as jprobability
from sykepic_tpu.ingest import ifcb as jifcb
from sykepic_tpu_torch.compute import probability
from sykepic_tpu_torch.ingest import ifcb, native

FIXTURE_ADC = Path("tests/data/raw/valid/D20180712T065600_IFCB114.adc")


def _require_native():
    assert native.lib() is not None, "the port's native library did not build"


def python_adc_parse(raw: bytes):
    lines = raw.splitlines()
    n = len(lines)
    widths = np.zeros(n, np.int64)
    heights = np.zeros(n, np.int64)
    starts = np.zeros(n, np.int64)
    for i, line in enumerate(lines):
        if not line:
            continue
        parts = line.split(b",")
        widths[i] = int(parts[15])
        heights[i] = int(parts[16])
        starts[i] = int(float(parts[17]))
    return widths, heights, starts


def _twin_parse(monkeypatch, tmp_path, raw: bytes):
    """The port's NumPy parser (``ifcb.parse_adc`` with no library)."""
    path = tmp_path / "twin.adc"
    path.write_bytes(raw)
    with monkeypatch.context() as m:
        m.setattr(native, "lib", lambda: None)
        return ifcb.parse_adc(path)


def _assert_parsed_equal(*results):
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def test_adc_parse_fixture(monkeypatch, tmp_path):
    _require_native()
    raw = FIXTURE_ADC.read_bytes()
    _assert_parsed_equal(native.adc_parse(raw), python_adc_parse(raw),
                         _twin_parse(monkeypatch, tmp_path, raw),
                         jifcb.parse_adc(FIXTURE_ADC))


def _row(w, h, s):
    cols = ["1"] * 24
    cols[15], cols[16], cols[17] = str(w), str(h), str(s)
    return ",".join(cols)


@pytest.mark.parametrize("sep,trailing", [("\n", True), ("\r\n", True),
                                          ("\n", False), ("\r\n", False)])
def test_adc_parse_synthetic_line_endings(monkeypatch, tmp_path, sep,
                                          trailing):
    _require_native()
    raw = sep.join(_row(i + 1, 2 * i, 100 * i) for i in range(5))
    raw = (raw + sep if trailing else raw).encode()
    w, h, s = native.adc_parse(raw)
    assert list(w) == [1, 2, 3, 4, 5]
    assert list(h) == [0, 2, 4, 6, 8]
    assert list(s) == [0, 100, 200, 300, 400]
    _assert_parsed_equal((w, h, s), _twin_parse(monkeypatch, tmp_path, raw))


def test_adc_parse_decimal_start_byte():
    _require_native()
    w, h, s = native.adc_parse(_row(3, 4, "123.000").encode())
    assert (w[0], h[0], s[0]) == (3, 4, 123)


def fuzz_adc(rng) -> bytes:
    """One random well-formed .adc body (the generator of
    ``tests/test_adc_fuzz.py``)."""
    lines = []
    for _ in range(int(rng.integers(1, 30))):
        cols = [str(rng.integers(0, 10**6))
                for _ in range(int(rng.integers(18, 30)))]
        cols[15] = str(int(rng.integers(0, 2000)))
        cols[16] = str(int(rng.integers(0, 2000)))
        start = int(rng.integers(0, 10**9))
        cols[17] = f"{start}.000" if rng.random() < 0.3 else str(start)
        lines.append(",".join(cols))
    sep = "\r\n" if rng.random() < 0.3 else "\n"
    raw = sep.join(lines)
    return (raw + sep if rng.random() < 0.5 else raw).encode()


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_native_matches_python(monkeypatch, tmp_path, seed):
    _require_native()
    rng = np.random.default_rng([7, seed])
    for _ in range(5):
        raw = fuzz_adc(rng)
        got = native.adc_parse(raw)
        assert got is not None
        _assert_parsed_equal(got, python_adc_parse(raw),
                             _twin_parse(monkeypatch, tmp_path, raw))


def _garbage_sample(root: Path, rng, trial: int) -> Path:
    name = f"D20200101T{trial:06d}_IFCB114"
    rows = []
    for _ in range(int(rng.integers(1, 6))):
        cols = [str(int(rng.integers(0, 100))) for _ in range(24)]
        cols[15] = str(int(rng.integers(0, 200)))
        cols[16] = str(int(rng.integers(0, 200)))
        cols[17] = str(int(rng.integers(0, 5000)))
        rows.append(",".join(cols))
    (root / f"{name}.adc").write_text("\n".join(rows) + "\n")
    rng.integers(0, 256, int(rng.integers(0, 3000))).astype(np.uint8).tofile(
        root / f"{name}.roi")
    return root / name


def _decode(module, sample):
    """The ROIs of a sample, or the class of the error it raised."""
    try:
        return [(rid, img.copy()) for rid, img in
                module.read_sample(sample).images()]
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_decode_isolation_as_jax(tmp_path, seed):
    """Random samples decode or raise ValueError (the class the pipelines
    isolate per sample), exactly where the JAX package's reader does."""
    rng = np.random.default_rng([11, seed])
    for trial in range(5):
        sample = _garbage_sample(tmp_path, rng, trial)
        got, want = _decode(ifcb, sample), _decode(jifcb, sample)
        if want is ValueError:
            assert got is ValueError
            continue
        assert [r for r, _ in got] == [r for r, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert a.ndim == 2
            np.testing.assert_array_equal(a, b)


def test_short_rows_fail_in_both_parsers(monkeypatch, tmp_path):
    """Rows of fewer than 18 columns: the native parser reports failure
    and the twin raises, as the JAX package's parser does."""
    _require_native()
    raw = b"1,2,3\n"
    assert native.adc_parse(raw) is None
    path = tmp_path / "short.adc"
    path.write_bytes(raw)
    with pytest.raises(IndexError):
        jifcb.parse_adc(path)
    with pytest.raises(IndexError):
        _twin_parse(monkeypatch, tmp_path, raw)


def _prob_rows(seed, n=200, c=50):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(c), size=n)
    probs[0, 0], probs[0, 1] = 0.0, 1.0
    probs[1, 0], probs[1, 1] = 0.000005, 0.999995  # rounding boundaries
    return np.arange(1, n + 1, dtype=np.int64), probs


def test_format_probs_matches_python():
    _require_native()
    roi_ids, probs = _prob_rows(0)
    body = native.format_probs(roi_ids, probs).decode()
    assert body.splitlines() == [
        f"{r}," + ",".join(f"{p:.5f}" for p in row)
        for r, row in zip(roi_ids, probs)]


@pytest.mark.parametrize("side", ["native", "twin"])
@pytest.mark.parametrize("form", ["rows", "arrays"])
def test_probabilities_to_csv_bytes_equal_jax(monkeypatch, tmp_path, side,
                                              form):
    roi_ids, probs = _prob_rows(2, n=20)
    classes = [f"c{i}" for i in range(probs.shape[1])]
    rows = (list(zip(roi_ids.tolist(), probs)) if form == "rows"
            else (roi_ids, probs))
    jprobability.probabilities_to_csv(rows, classes, tmp_path / "jax.csv")
    if side == "native":
        _require_native()
    else:
        monkeypatch.setattr(native, "lib", lambda: None)
    probability.probabilities_to_csv(rows, classes, tmp_path / "port.csv")
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())


def test_host_fingerprint_stable():
    a = native._host_fingerprint()
    assert a == native._host_fingerprint()
    assert len(a) == 16
