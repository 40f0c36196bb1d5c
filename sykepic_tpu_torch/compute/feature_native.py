"""Feature extraction: raw samples -> ``<sample>.feat.csv`` (the port of
``sykepic_tpu/compute/feature_native.py``; behavioral contract of reference
``sykepic/compute/feature_python.py``).

Exact-parity pieces: sample volume ``0.25 ml/min * (runTime - inhibitTime)/
60`` from the ``.hdr``; px^3 -> um^3 with micron factor 2.8; biomass =
``um3 / volume_ml / 1000``; the ``# version=`` / ``# volume_ml=`` comment
headers and 7-column CSV schema; optional per-sample multiprocessing; the
1 GB ``.roi`` filter and skip-if-exists/force semantics. The geometry
features come from :mod:`sykepic_tpu_torch.compute.features` (numpy and
scipy on the host).

The host features carry ``# version=tpu-v1`` (:data:`VERSION`); the fused
``pipeline --device-features`` pass writes the same schema under
``tpu-dev-v1``. Nothing on this path imports torch: ``--parallel`` starts
``spawn`` workers, each of which imports this module afresh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from multiprocessing import get_context
from pathlib import Path

from ..ingest import ifcb
from ..utils import files, logger
from .features import compute_features
from .units import PY_MICRON_FACTOR, biovolume_to_biomass

VERSION = "tpu-v1"
FILE_SUFFIX = ".feat"
CSV_COLUMNS = (
    "roi,biovolume_px,biovolume_um3,biomass_ugl,"
    "area,major_axis_length,minor_axis_length"
)
log = logger.get_logger("feat")


def pixels_to_um3(pixels, micron_factor: float = PY_MICRON_FACTOR):
    """Pixel volume -> um^3 (python-backend micron factor 2.8)."""
    return pixels / (micron_factor**3)


@dataclass
class RoiFeatureRow:
    """One CSV row of the feat schema."""

    roi: int
    biovolume_px: float
    biovolume_um3: float
    biomass_ugl: float
    area: int
    major_axis_length: float
    minor_axis_length: float

    @classmethod
    def from_image(cls, roi_id: int, image, volume_ml: float) -> "RoiFeatureRow":
        feats = dict(compute_features(image)[1])
        biovol_px = feats["Biovolume"]
        biovol_um3 = pixels_to_um3(biovol_px)
        return cls(
            roi=roi_id,
            biovolume_px=biovol_px,
            biovolume_um3=biovol_um3,
            biomass_ugl=biovolume_to_biomass(biovol_um3, volume_ml),
            area=feats["Area"],
            major_axis_length=feats["MajorAxisLength"],
            minor_axis_length=feats["MinorAxisLength"],
        )

    def as_csv(self) -> str:
        return ",".join(
            str(v)
            for v in (
                self.roi, self.biovolume_px, self.biovolume_um3,
                self.biomass_ugl, self.area, self.major_axis_length,
                self.minor_axis_length,
            )
        )


def sample_features(sample_path):
    """``(volume_ml, rows)`` for one sample, or None when the volume cannot
    be computed (logged, caller skips the sample)."""
    sample_path = Path(sample_path)
    try:
        volume_ml = ifcb.sample_volume(sample_path.with_suffix(".hdr"))
    except Exception:
        log.exception(f"Unable to calculate volume for {sample_path.name}")
        return None
    rows = [
        RoiFeatureRow.from_image(roi_id, image, volume_ml)
        for roi_id, image in ifcb.iter_rois(sample_path)
    ]
    return volume_ml, [
        (
            r.roi, r.biovolume_px, r.biovolume_um3, r.biomass_ugl,
            r.area, r.major_axis_length, r.minor_axis_length,
        )
        for r in rows
    ]


def features_to_csv(volume_ml, roi_features, csv_path) -> None:
    """Write the feat CSV (comment headers + 7 columns)."""
    csv_path = Path(csv_path)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        f"# version={VERSION}",
        f"# volume_ml={volume_ml}",
        CSV_COLUMNS,
    ]
    lines.extend(",".join(map(str, row)) for row in roi_features)
    csv_path.write_text("\n".join(lines) + "\n")


def process_sample(sample_path, out_dir, force: bool = False):
    """Extract one sample to its date-sharded CSV; returns the sample name
    (or None on failure)."""
    sample_path = Path(sample_path)
    csv_path = files.sample_csv_path(sample_path, out_dir, suffix=FILE_SUFFIX)
    if csv_path.is_file() and not force:
        log.warning(f"{csv_path.name} already exists, skipping")
        return sample_path.name
    if csv_path.is_file():
        log.warning(f"{csv_path.name} already exists, overwriting")
    log.info(f"Extracting features for {sample_path.name}")
    result = sample_features(sample_path)
    if result is None:
        return None
    features_to_csv(result[0], result[1], csv_path)
    return sample_path.name


def main(sample_paths, out_dir, parallel=False, force=False):
    """Run all samples, optionally on a spawn pool; returns processed names."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if parallel:
        cores = os.cpu_count()
        log.debug(f"Extracting features in parallel with {cores} cores")
        with get_context("spawn").Pool(cores) as pool:
            processed = pool.starmap(
                process_sample,
                [(path, out_dir, force) for path in sample_paths],
            )
    else:
        log.debug("Extracting features synchronously")
        processed = [
            process_sample(path, out_dir, force)
            for path in sorted(sample_paths)
        ]
    return set(filter(None, processed))


def call(args):
    """CLI adapter (argument surface = reference ``feature_python.py:16-30``)."""
    if args.raw:
        sample_paths = files.list_sample_paths(args.raw)
    else:
        sample_paths = [Path(path) for path in args.samples]
    small_enough = []
    for sample_path in sample_paths:
        if sample_path.with_suffix(".roi").stat().st_size <= 1e9:
            small_enough.append(sample_path)
        else:
            log.warning(f"{sample_path.name} is over 1G, skipping")
    return main(small_enough, args.out, args.parallel, args.force)
