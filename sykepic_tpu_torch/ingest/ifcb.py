"""IFCB raw-binary ingest: vectorized ``.adc`` / ``.roi`` / ``.hdr`` decoding.

Semantics-parity notes (against reference ``sykepic/utils/ifcb.py`` and
``sykepic/compute/feature_python.py``):

- An ``.adc`` file is a headerless CSV; per row, column 15 is ROI width,
  column 16 is ROI height, column 17 is the start byte into the ``.roi``
  payload (reference ``ifcb.py:105-107``; column semantics documented by the
  instrument header, see ``tests/data/raw/valid/*.hdr`` ``ADCFileFormat`` line).
- The ``.roi`` file is one flat ``uint8`` buffer; ROI *i* is
  ``roi_data[start:start + w*h].reshape(h, w)`` (reference ``ifcb.py:113-115``).
- Rows with width < 1 or height < 1 are empty triggers and skipped
  (reference ``ifcb.py:109-110``), but ROI ids stay 1-based adc row numbers
  (reference ``ifcb.py:103``).
- Sample volume (ml) = 0.25 ml/min * (runTime - inhibitTime)/60 from the
  ``.hdr`` (reference ``feature_python.py:105-118``).

Unlike the reference, decoding is fully vectorized (one ``bytes.splitlines``
pass + NumPy column extraction) and ROIs are exposed as zero-copy views into
the flat buffer so they can be packed straight into device-bound canvases
without a PNG round trip (reference writes PNGs to disk and re-reads them:
``compute/probability.py:147-154``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils import logger, png
from ..utils.timefmt import sample_to_datetime  # noqa: F401  (re-export)

log = logger.get_logger("ifcb")

# .adc column indices (0-based), per the instrument's ADCFileFormat header.
ADC_COL_WIDTH = 15
ADC_COL_HEIGHT = 16
ADC_COL_START = 17


def parse_adc(adc_path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse an ``.adc`` file into (widths, heights, start_bytes) int64 arrays.

    One entry per adc row (including empty-ROI rows), so that index ``i``
    corresponds to 1-based ROI number ``i + 1``.
    """
    raw = Path(adc_path).read_bytes()
    from . import native

    parsed = native.adc_parse(raw)
    if parsed is not None:
        return parsed
    lines = raw.splitlines()
    n = len(lines)
    widths = np.zeros(n, dtype=np.int64)
    heights = np.zeros(n, dtype=np.int64)
    starts = np.zeros(n, dtype=np.int64)
    for i, line in enumerate(lines):
        if not line:
            continue
        parts = line.split(b",")
        widths[i] = int(parts[ADC_COL_WIDTH])
        heights[i] = int(parts[ADC_COL_HEIGHT])
        starts[i] = int(float(parts[ADC_COL_START]))
    return widths, heights, starts


@dataclass
class SampleRois:
    """Decoded ROIs of one sample: flat payload + per-ROI geometry.

    ``roi_ids`` are 1-based adc row numbers of *non-empty* ROIs only, matching
    the reference's skip rule (``ifcb.py:109-110``) and PNG naming
    (``ifcb.py:116``, ``{sample}_{i:05}.png``).
    """

    sample: str
    roi_ids: np.ndarray  # (N,) int64, 1-based
    widths: np.ndarray  # (N,) int64
    heights: np.ndarray  # (N,) int64
    starts: np.ndarray  # (N,) int64 byte offsets
    roi_data: np.ndarray  # flat uint8 payload

    def __len__(self) -> int:
        return len(self.roi_ids)

    def image(self, i: int) -> np.ndarray:
        """ROI ``i`` (positional index) as a (h, w) uint8 view."""
        start = self.starts[i]
        h = int(self.heights[i])
        w = int(self.widths[i])
        return self.roi_data[start : start + h * w].reshape(h, w)

    def images(self):
        # plain-int loop: numpy scalar indexing costs ~4 interface objects
        # per ROI; .tolist() once per sample keeps the per-ROI cost to one
        # slice + reshape (this generator feeds the classify hot path)
        data = self.roi_data
        ids = self.roi_ids.tolist()
        npx = (self.heights * self.widths).tolist()
        hs = self.heights.tolist()
        ss = self.starts.tolist()
        for rid, h, n, s in zip(ids, hs, npx, ss):
            yield rid, data[s : s + n].reshape(h, n // h)


def read_sample(sample_path, validate: bool = True) -> SampleRois:
    """Decode ``<sample>.adc`` + ``<sample>.roi`` into a :class:`SampleRois`.

    Raises ``ValueError`` for truncated/faulty raw data (an adc row pointing
    past the end of the roi payload) -- the same error class the reference's
    ``reshape`` produces, which callers catch per-sample
    (``compute/probability.py:111-112``).
    """
    sample_path = Path(sample_path)
    adc = sample_path.with_suffix(".adc")
    roi = sample_path.with_suffix(".roi")
    for f in (adc, roi):
        if not f.is_file():
            raise FileNotFoundError(f)
    widths, heights, starts = parse_adc(adc)
    roi_data = np.fromfile(roi, dtype=np.uint8)
    keep = (widths >= 1) & (heights >= 1)
    roi_ids = np.nonzero(keep)[0] + 1  # 1-based adc row numbers
    widths, heights, starts = widths[keep], heights[keep], starts[keep]
    if validate and len(roi_ids):
        ends = starts + widths * heights
        if int(ends.max(initial=0)) > roi_data.size:
            raise ValueError(
                f"{sample_path.name}: adc references {int(ends.max())} bytes "
                f"but .roi holds only {roi_data.size}"
            )
        # negative start bytes would slice from the END of the payload --
        # silently wrong pixels, or a lazy reshape error that escapes the
        # per-sample isolation the callers rely on
        if int(starts.min(initial=0)) < 0:
            raise ValueError(
                f"{sample_path.name}: adc contains a negative ROI start byte"
            )
    return SampleRois(
        sample=sample_path.name,
        roi_ids=roi_ids,
        widths=widths,
        heights=heights,
        starts=starts,
        roi_data=roi_data,
    )


def raw_to_numpy(adc, roi):
    """Generator of ``(roi_number, 2-D uint8 array)`` -- parity with reference
    ``ifcb.py:121-130`` (including raising on truncated data at consume time).
    """
    sample = Path(adc).with_suffix("")
    rois = read_sample(sample, validate=True)
    yield from rois.images()


def iter_rois(sample_path):
    """Like :func:`raw_to_numpy` but takes the extension-less sample path."""
    rois = read_sample(sample_path, validate=True)
    yield from rois.images()


def raw_to_png(adc, roi, out_dir=None, force: bool = False) -> None:
    """Extract all ROIs of a sample to ``<sample>_{i:05}.png`` files.

    Parity with reference ``ifcb.py:76-118``: 1-based adc row number in the
    file name, empty ROIs skipped, grayscale PNG content.
    """
    adc = Path(adc)
    roi = Path(roi)
    for f in (adc, roi):
        if not f.is_file():
            raise FileNotFoundError(f)
    sample = adc.with_suffix("").name
    out_dir = Path(adc.with_suffix("")) if not out_dir else Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=force)
    rois = read_sample(adc.with_suffix(""), validate=True)
    for roi_number, img in rois.images():
        png.write_png(out_dir / f"{sample}_{roi_number:05}.png", img)


def extract_sample_images(sample, raw_dir, out_dir, exist_ok: bool = False) -> None:
    """Find a sample under ``raw_dir`` and extract its ROIs as PNGs
    (reference ``ifcb.py:46-73``)."""
    try:
        adc = next(Path(raw_dir).glob(f"**/{sample}.adc"))
    except StopIteration:
        log.error(f"Sample {sample} not found in {raw_dir}")
        raise
    raw_to_png(adc, adc.with_suffix(".roi"), out_dir, force=exist_ok)


def sample_volume(hdr_file) -> float:
    """Sample volume in ml from the ``.hdr`` run/inhibit times
    (reference ``feature_python.py:105-118``; raises on non-positive volume).
    """
    ifcb_flowrate = 0.25  # ml/min
    run_time = None
    inhibit_time = None
    with open(hdr_file) as fh:
        for line in fh:
            if line.startswith("inhibitTime"):
                inhibit_time = float(line.split()[1])
            elif line.startswith("runTime"):
                run_time = float(line.split()[1])
    sample_vol = ifcb_flowrate * ((run_time - inhibit_time) / 60.0)
    if sample_vol <= 0:
        raise ValueError(f"Sample volume is {sample_vol}")
    return sample_vol


def filter_out_quality_flagged_samples(sample_paths, exclusion_list):
    """Drop samples whose path contains any excluded sample name
    (reference ``ifcb.py:149-156``, substring match)."""
    with open(exclusion_list) as fh:
        # NOTE: blank lines are skipped. The reference keeps them
        # (``ifcb.py:152``), and a trailing empty string then matches every
        # path, silently excluding all samples.
        samples_to_exclude = [line.strip() for line in fh if line.strip()]
    return [
        Path(str(path))
        for path in sample_paths
        if not any(s in str(path) for s in samples_to_exclude)
    ]
