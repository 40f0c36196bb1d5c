"""Fused classify + features: one pass over raw IFCB data writes BOTH a
``.prob.csv`` and a ``.feat.csv`` per sample (the port of
``sykepic_tpu/compute/pipeline.py``).

Each sample is decoded once on the host; its ROIs are slot-packed (no
pre-shrink), each canvas goes to the device once, and two programs run on
that one copy: the classifier (K1 + the network) and the geometry feature
program (:mod:`sykepic_tpu_torch.ops.features_device`, whose floods are K2).
Features carry ``# version=tpu-dev-v1``, as the JAX package's on-device
features do.

The JAX package's other mode, host-thread features beside device
classification (``device_features=False``), needs the host feature
extractor; it comes with the ``feat`` sub-command (ROADMAP Queue 1 item 12)
and raises ``NotImplementedError`` here.

Under a mesh (``clf`` built with ``mesh=``; the CLI under ``torchrun``)
rank 0 reads the samples and writes the CSVs, and each rank runs both
programs on its share of every canvas batch.
"""

from __future__ import annotations

from pathlib import Path

from ..ingest import ifcb
from ..utils import files, logger
from . import feature_native, probability
from .engine import Classifier
from .units import biovolume_to_biomass

log = logger.get_logger("pipeline")

_HOST_FEATURES_LATER = (
    "host-thread features (pipeline without --device-features) need the "
    "host feature extractor, which comes with `feat` (ROADMAP Queue 1 item "
    "12); pass --device-features")


def call(args):
    """CLI adapter for the ``pipeline`` sub-command."""
    if args.raw:
        sample_paths = files.list_sample_paths(args.raw)
    else:
        sample_paths = [Path(p) for p in args.samples]
    filtered = []
    for sample_path in sample_paths:
        if sample_path.with_suffix(".roi").stat().st_size <= probability.MAX_ROI_BYTES:
            filtered.append(sample_path)
        else:
            log.warning(f"{sample_path.name} is over 1G, skipping")
    from .. import parallel

    mesh = None
    device = args.device
    if parallel.launched_by_torchrun():
        device = parallel.init_process_group(args.device)
        mesh = parallel.data_mesh()
    try:
        clf = probability.prepare_model(args.model,
                                        batch_size=args.batch_size,
                                        device=device, mesh=mesh)
        return main(
            filtered,
            clf,
            args.out,
            feat_out_dir=args.feat_out or args.out,
            force=args.force,
            feature_threads=args.num_workers,
            device_features=args.device_features,
        )
    finally:
        if mesh is not None:
            parallel.destroy_process_group()


def main(
    sample_paths,
    clf: Classifier,
    prob_out_dir,
    feat_out_dir=None,
    force: bool = False,
    feature_threads: int = 8,
    device_features: bool = False,
):
    """Single pass: decode once -> classify + features on ``clf``'s device.

    Only ``device_features=True`` is ported: features are computed on the
    device in the classification batch stream. ``feature_threads`` is
    accepted for the JAX signature (it sizes the host-thread mode).

    Returns the set of sample names fully processed (the empty set on the
    other ranks of a mesh, which serve rank 0's dispatches).
    """
    if not device_features:
        raise NotImplementedError(_HOST_FEATURES_LATER)
    if clf.follower:
        clf.follow()
        return set()
    try:
        return _main_device_features(
            sample_paths, clf, prob_out_dir, feat_out_dir or prob_out_dir,
            force)
    finally:
        clf.release()


def _plan(sample_paths, prob_out_dir, feat_out_dir, force):
    """(todo, prob_csvs, feat_csvs): samples needing work and their output
    paths — no decoding happens here."""
    todo = []
    prob_csvs = {}
    feat_csvs = {}
    for idx, sample_path in enumerate(Path(p) for p in sample_paths):
        prob_csv = files.sample_csv_path(sample_path, prob_out_dir,
                                         probability.FILE_SUFFIX)
        feat_csv = files.sample_csv_path(sample_path, feat_out_dir,
                                         feature_native.FILE_SUFFIX)
        if prob_csv.is_file() and feat_csv.is_file() and not force:
            log.warning(f"{sample_path.name} outputs exist, skipping")
            continue
        todo.append((idx, sample_path))
        prob_csvs[idx] = prob_csv
        feat_csvs[idx] = feat_csv
    return todo, prob_csvs, feat_csvs


def _main_device_features(sample_paths, clf, prob_out_dir, feat_out_dir,
                          force):
    """Fused on-device pass: one ROI stream, two device programs per
    batch."""
    todo, prob_csvs, feat_csvs = _plan(sample_paths, prob_out_dir,
                                       feat_out_dir, force)

    prob_rows: dict[int, list] = {}
    feat_rows: dict[int, list] = {}
    expected: dict[int, int] = {}
    names: dict[int, str] = {}
    volumes: dict[int, float] = {}

    def roi_stream():
        for idx, sample_path in todo:
            try:
                rois = ifcb.read_sample(sample_path)
                volumes[idx] = ifcb.sample_volume(
                    sample_path.with_suffix(".hdr")
                )
            except ValueError:
                log.exception(f"Faulty raw data for {sample_path.name}")
                continue
            except Exception:
                log.exception(f"Unexpected error for {sample_path.name}")
                continue
            prob_rows.setdefault(idx, [])
            feat_rows.setdefault(idx, [])
            expected[idx] = len(rois)
            names[idx] = sample_path.name
            for rid, img in rois.images():
                yield idx, rid, img

    written = set()

    def flush(idx):
        probability.probabilities_to_csv(
            sorted(prob_rows.pop(idx), key=lambda r: r[0]), clf.classes,
            prob_csvs[idx]
        )
        csv_path = Path(feat_csvs[idx])
        csv_path.parent.mkdir(parents=True, exist_ok=True)
        lines = [
            "# version=tpu-dev-v1",
            f"# volume_ml={volumes[idx]}",
            feature_native.CSV_COLUMNS,
        ]
        lines.extend(
            ",".join(map(str, row)) for row in sorted(feat_rows.pop(idx))
        )
        csv_path.write_text("\n".join(lines) + "\n")
        written.add(names[idx])

    flushed = set()
    for idx, rid, probs, feats in clf.classify_and_feature_rois(roi_stream()):
        prob_rows[idx].append((rid, probs))
        area, biovol_px, major, minor = feats
        biovol_um3 = feature_native.pixels_to_um3(biovol_px)
        feat_rows[idx].append(
            (
                rid, biovol_px, biovol_um3,
                biovolume_to_biomass(biovol_um3, volumes[idx]),
                int(area), major, minor,
            )
        )
        if len(prob_rows[idx]) == expected[idx]:
            flushed.add(idx)
            flush(idx)
    for idx in list(prob_rows):
        if idx not in flushed:
            flush(idx)
    return written
