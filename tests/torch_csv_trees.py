"""Input trees shared by ``tests/test_torch_{csv_tools,evaluation}.py``: the
repo's fixture sample and randomized ``.prob.csv``/``.feat.csv`` trees made
from a numpy seed (the generator of ``tests/test_oracle_postprocess.py``,
widened), and a runner that drives the JAX package's CLI and the port's on
the same arguments and returns what each wrote.

A randomized tree spans two calendar months in the date-sharded
``YYYY/MM/DD`` layout, names the taxa that the post-processing corrects
(coiled Dolichospermum and Nodularia, Aphanizomenon), gives some ROIs the
large biovolumes of the Nodularia-coiled branch, holds one sample with no
ROIs, and leaves one class out of its thresholds file; a second thresholds
file (``zero``) holds every class at 0.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parent.parent
FIXTURE_PROBS = REPO / "tests/data/prob"
FIXTURE_FEATS = REPO / "tests/data/feat"
T2021 = REPO / "tests/model/thresholds-2021.txt"
ZERO = REPO / "tests/model/thresholds-zero.txt"
GROUPS = REPO / "tests/model/size-groups.txt"
FIXTURE_SAMPLE = "D20180712T065600_IFCB114"

CLASSES = [
    "Class_A", "Class_B", "Class_C",
    "Aphanizomenon_flosaquae",
    "Dolichospermum-Anabaenopsis",
    "Dolichospermum-Anabaenopsis-coiled",
    "Nodularia_spumigena",
    "Nodularia_spumigena-coiled",
    "unclassifiable",
]
FEAT_COLUMNS = ("biovolume_px", "biovolume_um3", "biomass_ugl", "area",
                "major_axis_length", "minor_axis_length")


def _sample_name(start: datetime, i: int) -> str:
    ts = start + timedelta(days=9 * i, minutes=53 * i)
    return f"D{ts:%Y%m%dT%H%M%S}_IFCB114"


def _shard(root: Path, name: str) -> Path:
    d = root / name[1:5] / name[5:7] / name[7:9]
    d.mkdir(parents=True, exist_ok=True)
    return d


def random_tree(root: Path, seed: int, n_samples: int = 6,
                max_rois: int = 40) -> SimpleNamespace:
    """A randomized prob/feat tree under ``root`` (see the module
    docstring); sample 2 has no ROIs."""
    rng = np.random.default_rng(seed)
    probs_dir, feats_dir = root / "probs", root / "feats"
    names = []
    for s in range(n_samples):
        name = _sample_name(datetime(2021, 6, 3, 5), s)
        names.append(name)
        n_rois = 0 if s == 2 else int(rng.integers(5, max_rois))
        raw = rng.dirichlet(np.ones(len(CLASSES)) * 0.4, size=n_rois)
        volume_ml = float(rng.uniform(0.6, 1.2))
        prob_lines = ["roi," + ",".join(CLASSES)]
        feat_lines = ["# version=py-v4", f"# volume_ml={volume_ml}",
                      "roi," + ",".join(FEAT_COLUMNS)]
        rois = np.sort(rng.choice(np.arange(1, 4 * max_rois), n_rois,
                                  replace=False))
        for r, roi in enumerate(rois):
            prob_lines.append(f"{roi}," + ",".join(
                f"{v:.5f}" for v in np.round(raw[r], 5)))
            biovol_px = float(rng.uniform(1e2, 1e4) if rng.random() < 0.75
                              else rng.uniform(4e6, 9e6))
            biovol_um3 = biovol_px / 2.8 ** 3
            feat_lines.append(
                f"{roi},{biovol_px},{biovol_um3},"
                f"{biovol_um3 / volume_ml / 1000},"
                f"{int(rng.integers(10, 3000))},"
                f"{rng.uniform(3, 120):.6f},{rng.uniform(2, 60):.6f}")
        (_shard(probs_dir, name) / f"{name}.prob.csv").write_text(
            "\n".join(prob_lines) + "\n")
        (_shard(feats_dir, name) / f"{name}.feat.csv").write_text(
            "\n".join(feat_lines) + "\n")
    thresholds = root / "thresholds.txt"
    thresholds.write_text("\n".join(
        f"{c} {rng.uniform(0.2, 0.7):.2f}" for c in CLASSES[1:]) + "\n")
    zero = root / "thresholds-zero.txt"
    zero.write_text("".join(f"{c} 0.0\n" for c in CLASSES))
    groups = root / "groups.txt"
    groups.write_text("small 0\nmedium 400\nlarge 3000\nhuge 2000000\n")
    divisions = root / "divisions.txt"
    divisions.write_text("Class_B 500 5000\nNodularia_spumigena 1000\n")
    exclusion = root / "exclude.txt"
    exclusion.write_text(f"{names[1]}\n\n{names[4]}\n")
    return SimpleNamespace(probs=probs_dir, feats=feats_dir,
                           thresholds=thresholds, zero=zero, groups=groups,
                           divisions=divisions, exclusion=exclusion,
                           names=names, root=root)


def fixture_tree(root: Path) -> SimpleNamespace:
    """The repo's fixture sample with its thresholds and size groups."""
    divisions = root / "divisions.txt"
    divisions.write_text("Uroglenopsis_sp 100\nDinophyceae 50 20000\n")
    exclusion = root / "exclude.txt"
    exclusion.write_text("D20990101T000000_IFCB114\n")
    return SimpleNamespace(probs=FIXTURE_PROBS, feats=FIXTURE_FEATS,
                           thresholds=T2021, zero=ZERO, groups=GROUPS,
                           divisions=divisions, exclusion=exclusion,
                           names=[FIXTURE_SAMPLE], root=root)


def make_tree(kind: str, root: Path) -> SimpleNamespace:
    """``"fixture"`` or ``"seed<N>"``."""
    root.mkdir(parents=True, exist_ok=True)
    if kind == "fixture":
        return fixture_tree(root)
    return random_tree(root, int(kind.removeprefix("seed")))


def outputs(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def run_both(argv_of, out_root: Path, before=None) -> dict:
    """Run ``argv_of(out_dir)`` through the JAX package's CLI and through
    the port's, each with its own empty ``out_dir`` under ``out_root``
    (``before(out_dir)`` first, where given). Returns ``{"jax": ...,
    "port": ...}``, each ``(exception type or None, {file: bytes})``."""
    from sykepic_tpu.__main__ import main as jax_main
    from sykepic_tpu_torch.__main__ import main as port_main

    result = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = out_root / name
        out.mkdir(parents=True)
        if before is not None:
            before(out)
        try:
            main([str(a) for a in argv_of(out)])
            error = None
        except (Exception, SystemExit) as e:  # compared between packages
            error = type(e)
        result[name] = (error, outputs(out))
    return result
