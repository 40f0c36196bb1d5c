"""Fused classify + features: one pass over raw IFCB data writes BOTH a
``.prob.csv`` and a ``.feat.csv`` per sample (the port of
``sykepic_tpu/compute/pipeline.py``).

Each sample is decoded once on the host. Two modes:

- host-thread features (the default, ``device_features=False``): the
  sample's ROIs stream through the classifier on the device (K1 + the
  network) while a pool of ``feature_threads`` host threads computes the
  geometry features of the same decode
  (:func:`sykepic_tpu_torch.compute.features.compute_features`, numpy and
  scipy). Features carry ``# version=tpu-v1``, byte for byte what ``feat``
  writes. A bounded semaphore holds the backlog of decoded samples waiting
  for a feature thread to ``max(2 * feature_threads, 4)``. This is the mode
  the ``watch`` daemon runs.
- on-device features (``device_features=True``): the ROIs are slot-packed
  (no pre-shrink), each canvas goes to the device once, and two programs
  run on that one copy: the classifier and the geometry feature program
  (:mod:`sykepic_tpu_torch.ops.features_device`, whose floods are K2).
  Features carry ``# version=tpu-dev-v1``, as the JAX package's on-device
  features do.

Under a mesh (``clf`` built with ``mesh=``; the CLI under ``torchrun``)
rank 0 reads the samples, runs the feature threads and writes the CSVs,
and each rank runs the device programs on its share of every batch.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..ingest import ifcb, pack
from ..utils import files, logger
from . import feature_native, probability
from .engine import Classifier
from .features import compute_features
from .units import biovolume_to_biomass

log = logger.get_logger("pipeline")


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
    """Single pass: decode once -> classify on ``clf``'s device +
    features, on ``feature_threads`` host threads (``# version=tpu-v1``)
    or, with ``device_features``, on the device (``# version=tpu-dev-v1``).

    Returns the set of sample names fully processed: in the host-thread
    mode only those whose two CSVs both landed (the ``watch`` daemon
    retries the rest). The empty set on the other ranks of a mesh, which
    serve rank 0's dispatches.
    """
    if clf.follower:
        clf.follow()
        return set()
    feat_out_dir = feat_out_dir or prob_out_dir
    try:
        if device_features:
            return _main_device_features(
                sample_paths, clf, prob_out_dir, feat_out_dir, force)
        return _main_host_features(sample_paths, clf, prob_out_dir,
                                   feat_out_dir, force, feature_threads)
    finally:
        clf.release()


def _main_host_features(sample_paths, clf, prob_out_dir, feat_out_dir,
                        force, feature_threads):
    """Device classification with host-thread features beside it
    (``sykepic_tpu/compute/pipeline.py:78-172``). Each sample goes to the
    classifier as one columnar
    :class:`~sykepic_tpu_torch.ingest.pack.RoiBlock`, as ``prob`` sends
    it, and to a feature thread as its decoded ROIs."""
    todo, prob_csvs, feat_csvs = _plan(sample_paths, prob_out_dir,
                                       feat_out_dir, force)

    results: dict[int, list] = {}  # idx -> [(roi_ids, probs) blocks]
    expected: dict[int, int] = {}
    names: dict[int, str] = {}

    # Feature jobs hold their sample's decoded payload; bound the backlog so
    # memory stays O(threads), not O(archive) (classification usually runs
    # faster than host feature extraction).
    backlog = threading.BoundedSemaphore(max(2 * feature_threads, 4))

    def feature_worker(rois, volume_ml, feat_csv, name):
        try:
            roi_features = []
            for roi_id, img in rois.images():
                feats = dict(compute_features(img)[1])
                biovol_px = feats["Biovolume"]
                biovol_um3 = feature_native.pixels_to_um3(biovol_px)
                roi_features.append(
                    (
                        roi_id, biovol_px, biovol_um3,
                        biovolume_to_biomass(biovol_um3, volume_ml),
                        feats["Area"], feats["MajorAxisLength"],
                        feats["MinorAxisLength"],
                    )
                )
            feature_native.features_to_csv(volume_ml, roi_features, feat_csv)
            return name
        except Exception:
            # per-sample isolation, like the decode/classify side: one bad
            # ROI must not abort the whole multi-sample run
            log.exception(f"Feature extraction failed for {name}")
            return None
        finally:
            backlog.release()

    written = set()
    with ThreadPoolExecutor(max_workers=max(feature_threads, 1),
                            thread_name_prefix="sykepic-feat") as pool:
        feat_futures = []

        def roi_stream():
            # lazy per-sample decode (on the engine's producer thread):
            # memory stays bounded by the in-flight device batches plus the
            # feature backlog
            for idx, sample_path in todo:
                try:
                    rois = ifcb.read_sample(sample_path)
                    volume_ml = ifcb.sample_volume(
                        sample_path.with_suffix(".hdr")
                    )
                except ValueError:
                    log.exception(f"Faulty raw data for {sample_path.name}")
                    continue
                except Exception:
                    log.exception(f"Unexpected error for {sample_path.name}")
                    continue
                results.setdefault(idx, [])
                expected[idx] = len(rois)
                names[idx] = sample_path.name
                backlog.acquire()
                feat_futures.append(
                    pool.submit(feature_worker, rois, volume_ml,
                                feat_csvs[idx], sample_path.name)
                )
                yield pack.RoiBlock(
                    sample_idx=idx, roi_ids=rois.roi_ids,
                    heights=rois.heights, widths=rois.widths,
                    offsets=rois.starts, base=rois.roi_data,
                )

        def flush(idx):
            probability.probabilities_to_csv(
                probability.sorted_rows(results.pop(idx)), clf.classes,
                prob_csvs[idx])
            written.add(names[idx])

        flushed = set()
        for idx in probability.completed_samples(
                clf.classify_blocks(roi_stream()), results, expected):
            flushed.add(idx)
            flush(idx)
        for idx in list(results):  # zero-ROI samples
            if idx not in flushed:
                flush(idx)
        clf.timer.report()
        feat_done = {r for r in (f.result() for f in feat_futures) if r}

    if feat_done != written:
        log.warning("feature/probability sample mismatch: "
                    f"{feat_done ^ written}")
    # a sample only counts as processed when BOTH outputs landed — the watch
    # daemon uses this set to decide what to retry next cycle (a feat-only
    # retry re-runs the sample; the existing prob CSV is simply rewritten)
    return written & feat_done


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
