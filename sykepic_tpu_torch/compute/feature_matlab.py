"""MATLAB ifcb-analysis feature backend (the port of
``sykepic_tpu/compute/feature_matlab.py``; behavioral contract of reference
``sykepic/compute/feature_matlab.py``).

Drives an external MATLAB installation's blob/feature batch scripts over the
raw samples, then rewrites the resulting ``*_fea_v2.csv`` files into the
shared 7-column feat schema with px^3 -> um^3 conversion (micron factor
3.5) and biomass per sample volume.

pandas reads the MATLAB CSVs. It is imported inside the functions that need
it (:func:`_pandas`), so the rest of the port runs without it.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from pathlib import Path
from tempfile import TemporaryDirectory

from ..ingest import ifcb
from ..utils import files, logger
from .units import MATLAB_MICRON_FACTOR, biovolume_to_biomass, pixels_to_um3

VERSION = 2
FILE_SUFFIX = ".feat"
OUTPUT_COLUMNS = [
    "roi",
    "biovolume_px",
    "biovolume_um3",
    "biomass_ugl",
    "area",
    "major_axis_length",
    "minor_axis_length",
]
RENAMES = {
    "roi_number": "roi",
    "Area": "area",
    "Biovolume": "biovolume_px",
    "MajorAxisLength": "major_axis_length",
    "MinorAxisLength": "minor_axis_length",
}

log = logger.get_logger("feat")


def _pandas():
    """pandas, which reads the MATLAB CSVs, or a clear ImportError."""
    try:
        import pandas
    except ImportError as e:
        raise ImportError("feat --matlab reads the MATLAB feature CSVs with "
                          "pandas, which is not installed") from e
    return pandas


@dataclass
class MatlabBatch:
    """One invocation of the ifcb-analysis MATLAB batch over a sample set."""

    binary: str
    out_dir: Path

    @property
    def blob_dir(self) -> Path:
        return self.out_dir / "matlab" / "blob"

    @property
    def feat_dir(self) -> Path:
        return self.out_dir / "matlab" / "feat"

    def run(self, sample_paths, parallel: bool) -> None:
        # ifcb-analysis errors out when parallel is requested for one sample
        par_flag = "true" if parallel and len(sample_paths) > 1 else ""
        with TemporaryDirectory(prefix="tmp-", dir=self.out_dir) as staging:
            self._stage(sample_paths, Path(staging))
            self._matlab(
                "start_blob_batch_user_training("
                f"'{staging}/', '{self.blob_dir.resolve()}/', '{par_flag}')",
                "Blob extraction",
            )
            self._matlab(
                "start_feature_batch_user_training("
                f"'{staging}/', '{self.blob_dir.resolve()}/', "
                f"'{self.feat_dir.resolve()}/', '{par_flag}')",
                "Feature extraction",
            )

    @staticmethod
    def _stage(sample_paths, staging: Path) -> None:
        """Symlink raw triplets grouped by day prefix (``sample[:9]``)."""
        for sample_path in sample_paths:
            day_dir = staging / sample_path.stem[:9]
            day_dir.mkdir(exist_ok=True)
            for ext in (".adc", ".hdr", ".roi"):
                raw = sample_path.with_suffix(ext)
                (day_dir / raw.name).symlink_to(raw.resolve())

    def _matlab(self, command: str, label: str) -> None:
        result = subprocess.run(
            [
                self.binary, "-nodisplay", "-nosplash", "-nodesktop", "-r",
                f"try {command}; catch me, disp(me.message), exit(1); "
                "end; exit(0)",
            ],
            capture_output=True,
        )
        text = result.stdout[375:].decode()  # skip the MATLAB banner
        if result.returncode != 0:
            log.error(f"{label} failed: {text}")
        else:
            log.debug(text)

    def collect(self, sample_path: Path):
        """Read back one sample's feature CSV in the shared schema, or None
        when MATLAB produced nothing / the volume is unavailable."""
        pd = _pandas()
        fea_csv = self.feat_dir / f"{sample_path.stem}_fea_v{VERSION}.csv"
        try:
            frame = pd.read_csv(fea_csv)
            volume_ml = ifcb.sample_volume(sample_path.with_suffix(".hdr"))
        except FileNotFoundError:
            log.exception(f"Matlab features missing for {sample_path.name}")
            return None
        except Exception:
            log.exception(f"Unable to calculate volume for {sample_path.name}")
            return None
        um3 = pixels_to_um3(frame["Biovolume"], MATLAB_MICRON_FACTOR)
        frame["biovolume_um3"] = um3
        frame["biomass_ugl"] = biovolume_to_biomass(um3, volume_ml)
        frame = frame.rename(columns=RENAMES)
        return volume_ml, frame[OUTPUT_COLUMNS]


def main(bin, sample_paths, out_dir, parallel):
    _pandas()  # before hours of MATLAB, not after
    out_dir = Path(out_dir)
    out_dir.mkdir(exist_ok=True)
    batch = MatlabBatch(binary=bin, out_dir=out_dir)
    batch.run(sample_paths, parallel)

    processed = set()
    for sample_path in sorted(sample_paths):
        result = batch.collect(sample_path)
        if result is not None:
            volume_ml, frame = result
            out_csv = files.sample_csv_path(sample_path, out_dir, FILE_SUFFIX)
            out_csv.parent.mkdir(parents=True, exist_ok=True)
            with open(out_csv, "w") as fh:
                fh.write(f"# version={VERSION}\n# volume_ml={volume_ml}\n")
                frame.to_csv(fh, index=False)
            processed.add(sample_path.stem)
    return processed


def call(args):
    """CLI adapter (argument surface = reference ``feature_matlab.py:16-29``)."""
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
    return main(args.matlab, small_enough, args.out, args.parallel)
