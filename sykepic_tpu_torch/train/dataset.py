"""Dataset curation: copy/filter a labeled folder-per-class dataset
(reference ``sykepic/train/dataset.py`` — present there as library code
whose ``main`` was never wired into the CLI)."""

from __future__ import annotations

import shutil
from pathlib import Path

from .data import list_files


def create_dataset(src, dst, min_N=None, max_N=None, exclude=(), random_seed=24):
    """Copy ``src`` (folder-per-class) to ``dst``, dropping classes smaller
    than ``min_N``, capping classes at ``max_N`` (seeded shuffle selection),
    skipping ``exclude`` directories; files are renamed ``label_i.ext``
    (reference ``dataset.py:11-56``)."""
    src = Path(src)
    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    copied = {}
    for class_dir in sorted(p for p in src.iterdir() if p.is_dir()):
        if class_dir.name in exclude:
            continue
        paths = sorted(
            list_files(class_dir, ".png", min_N, max_N, list(exclude), random_seed)
        )
        if not paths:
            continue
        out_dir = dst / class_dir.name
        out_dir.mkdir(exist_ok=True)
        for i, path in enumerate(paths):
            shutil.copy(path, out_dir / f"{class_dir.name}_{i}{path.suffix}")
        copied[class_dir.name] = len(paths)
    return copied
