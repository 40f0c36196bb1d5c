"""Filesystem layout helpers (parity with reference ``sykepic/utils/files.py``).

Contracts kept from the reference:

- Output CSVs are sharded by the sample's acquisition date:
  ``out_dir/YYYY/MM/DD/<sample><suffix>.csv`` (reference ``files.py:27-37``).
- Sample discovery is a recursive glob for ``**/*.roi`` with the suffix
  stripped (reference ``files.py:40-44``).
"""

import tarfile
import zipfile
from pathlib import Path

from .timefmt import sample_to_datetime


def sample_csv_path(sample_path, out_dir, suffix=None) -> Path:
    """Date-sharded CSV path for a sample (reference ``files.py:27-37``)."""
    sample = Path(sample_path).name
    out_name = f"{sample}{suffix}.csv" if suffix else f"{sample}.csv"
    return (
        Path(out_dir) / sample_to_datetime(sample).strftime("%Y/%m/%d") / out_name
    )


def list_sample_paths(root_dir, filter=None):
    """All sample paths (``.roi`` stems) under a raw-data tree, sorted
    (reference ``files.py:40-44`` returns filesystem order; deterministic
    order makes batch runs reproducible)."""
    stems = [p.with_suffix("") for p in sorted(Path(root_dir).rglob("*.roi"))]
    if filter is None:
        return stems
    return [p for p in stems if p.name in filter]


def list_sample_csvs(root_dir, filter=None):
    """CSV files under a tree, optionally filtered by sample name
    (reference ``files.py:47-52``)."""
    return [
        path
        for path in Path(root_dir).glob("**/*.csv")
        if not filter or path.with_suffix("").stem in filter
    ]


_TAR_MODES = {"tar": "w", "gzip": "w:gz", "tar.gz": "w:gz", "gz": "w:gz"}


def create_archive(src, dest, compression) -> None:
    """Archive a directory's immediate entries (same formats as reference
    ``files.py:10-24``: tar, gzip/tar.gz/gz, zip). Entries are added in
    sorted order so archives are reproducible."""
    entries = sorted(Path(src).iterdir()) if Path(src).is_dir() else None
    if entries is None:
        raise ValueError(f"{src} does not exist")
    if compression == "zip":
        with zipfile.ZipFile(dest, "w", zipfile.ZIP_DEFLATED) as archive:
            for entry in entries:
                archive.write(entry, arcname=entry.name)
    elif compression in _TAR_MODES:
        with tarfile.open(dest, _TAR_MODES[compression]) as archive:
            for entry in entries:
                archive.add(entry, arcname=entry.name)
    else:
        raise ValueError(f"Unknown compression {compression}")
