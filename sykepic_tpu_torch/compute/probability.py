"""Compute class probabilities for raw IFCB data (reference
``sykepic/compute/probability.py``; the port of
``sykepic_tpu/compute/probability.py``).

Same contracts as the reference:

- input modes: raw dir / sample list / image dir / image list, with images
  grouped by sample-name prefix (reference ``probability.py:27-43``); PNGs
  are read by :mod:`sykepic_tpu_torch.utils.png` and colour reduced as
  ``cv2.cvtColor(BGR2GRAY)`` does it, as the JAX package reads them
- samples with a ``.roi`` over 1 GB are skipped (``:44-53``)
- per-sample error isolation: faulty raw data logs and continues (``:106-115``)
- skip-if-CSV-exists idempotency with ``force`` override (``:136-141``)
- output: ``out_dir/YYYY/MM/DD/<sample>.prob.csv`` with header
  ``roi,<classes...>`` and probabilities at 5 decimals, roi-ascending
  (``:200-206``)
- softmax temperature ``ln(1.3)`` inside the engine (``:18,191-194``)

ROIs decode straight from the ``.roi`` payload into packed device batches,
and ROIs of different samples share device batches.

Under a mesh (:func:`prepare_model` with ``mesh=``, one process per card)
rank 0 reads the samples, feeds the :class:`Classifier` and writes every
CSV; the other ranks serve its dispatches (:meth:`Classifier.follow`) until
rank 0 releases them at the end of :func:`main`.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..ingest import ifcb, native, pack
from ..utils import files, logger, png
from .engine import Classifier
from .output import progress

FILE_SUFFIX = ".prob"
MAX_ROI_BYTES = 1e9
log = logger.get_logger("prob")


def call(args):
    """CLI adapter (argument surface = reference ``probability.py:27-64``).
    Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank runs it and the
    classifier runs on a data mesh over the group."""
    if args.image_dir or args.images:
        samples_as_images = True
        if args.image_dir:
            img_paths = sorted(Path(args.image_dir).rglob("*.png"))
        else:
            img_paths = sorted(Path(path) for path in args.images)
        sample_paths = {}
        for sample, img_path in ((p.name.rpartition("_")[0], p)
                                 for p in img_paths):
            sample_paths.setdefault(sample, []).append(img_path)
    else:
        samples_as_images = False
        if args.raw:
            sample_paths = files.list_sample_paths(args.raw)
        else:
            sample_paths = [Path(path) for path in args.samples]
        filtered = []
        for sample_path in sample_paths:
            if sample_path.with_suffix(".roi").stat().st_size <= MAX_ROI_BYTES:
                filtered.append(sample_path)
            else:
                log.warning(f"{sample_path.name} is over 1G, skipping")
        sample_paths = filtered
    from .. import parallel

    mesh = None
    if parallel.launched_by_torchrun():
        device = parallel.init_process_group(args.device)
        mesh = parallel.data_mesh()
    else:
        device = args.device
    try:
        main(
            sample_paths,
            args.model,
            args.out,
            args.batch_size,
            args.num_workers,
            args.force,
            progress_bar=True,
            samples_as_images=samples_as_images,
            device=device,
            mesh=mesh,
        )
    finally:
        if mesh is not None:
            parallel.destroy_process_group()


def main(
    sample_paths,
    model_dir,
    out_dir,
    batch_size: int = 64,
    num_workers: int = 2,  # accepted for CLI parity; host feed is threaded
    force: bool = False,
    progress_bar: bool = True,
    samples_as_images: bool = False,
    classifier: Classifier | None = None,
    device=None,
    mesh=None,
):
    """Classify samples and write one ``.prob.csv`` per sample on
    ``device`` (``cuda`` unless the caller asks for ``cpu``).
    ``samples_as_images``: ``sample_paths`` maps a sample name to its PNG
    paths, and each sample's CSV lands in ``out_dir`` itself. ``mesh``: a
    data (or data x model) mesh of :mod:`sykepic_tpu_torch.parallel`; every
    rank calls this function, rank 0 does the file work.

    Returns the set of sample names processed (reference ``:105-115``);
    the empty set on the other ranks of a mesh.
    """
    clf = classifier or prepare_model(
        model_dir, batch_size=max(batch_size, 1), device=device, mesh=mesh)
    if clf.follower:
        clf.follow()
        return set()
    try:
        if samples_as_images:
            items = sample_paths.items()
            for sample, img_paths in (
                    progress(items, "Processing samples") if progress_bar
                    else items):
                csv_path = Path(out_dir) / f"{sample}{FILE_SUFFIX}.csv"
                process_images(img_paths, clf, csv_path, force)
            return set(sample_paths)
        return process_samples_batched(
            sample_paths, clf, out_dir, force, progress_bar=progress_bar)
    finally:
        clf.release()


def prepare_model(model_dir, batch_size: int = 256, dtype: str = "float32",
                  device=None, mesh=None):
    """Load the model directory into a ready :class:`Classifier`
    (reference ``probability.py:118-130``). ``mesh`` enables multi-card
    runs (data axis; plus tensor parallel when it has a model axis)."""
    return Classifier(model_dir, batch_size=batch_size, dtype=dtype,
                      device=device, mesh=mesh)


def _sample_blocks(sample_paths):
    """One columnar RoiBlock per readable sample (unreadable ones are
    skipped: the classify pass reports them)."""
    for idx, p in enumerate(sample_paths):
        try:
            rois = ifcb.read_sample(p)
        except Exception:
            continue
        yield pack.RoiBlock(
            sample_idx=idx, roi_ids=rois.roi_ids, heights=rois.heights,
            widths=rois.widths, offsets=rois.starts, base=rois.roi_data,
        )


def precompile_for_samples(sample_paths, clf: Classifier) -> int:
    """Warm up every dispatch shape the given samples will produce through
    :meth:`Classifier.classify_rois`: packs them exactly like that path to
    list the shapes, then dispatches one zeros batch per shape. Returns the
    number of shapes."""
    shapes = {(b.windows.shape[0], len(b.win_idx)) if clf.packing == "shelf"
              else b.canvas.shape
              for b in clf._packed(_sample_blocks(sample_paths))}
    return clf.precompile(sorted(shapes))


def process_sample(sample_path, clf: Classifier, out_dir, force: bool = False):
    """Decode one sample, classify its ROIs, write the CSV.

    Raises ``ValueError`` on faulty raw data (caller isolates per sample).
    """
    sample_path = Path(sample_path)
    sample = sample_path.name
    csv_path = files.sample_csv_path(sample_path, out_dir, suffix=FILE_SUFFIX)
    if csv_path.is_file():
        if force:
            log.warning(f"{csv_path.name} already exists, overwriting")
        else:
            log.warning(f"{csv_path.name} already exists, skipping")
            return sample
    log.debug(f"Computing probabilities for {sample}")
    rois = ifcb.read_sample(sample_path)  # ValueError on truncated data
    results = sorted(
        (roi_id, probs)
        for _, roi_id, probs in clf.classify_rois(
            (0, rid, img) for rid, img in rois.images()
        )
    )
    probabilities_to_csv(results, clf.classes, csv_path)
    return sample


def process_samples_batched(sample_paths, clf: Classifier, out_dir,
                            force: bool = False, progress_bar: bool = False):
    """High-throughput path: stream ROIs of *all* samples through shared
    device batches; per-sample decode errors are isolated.

    Returns the set of sample names processed (written or skipped-existing,
    matching the reference's accounting, ``probability.py:105-115``).
    """
    # one span over the whole job, so that its Python between the finer
    # spans (output paths, the streams' set-up) is named in a trace too
    with clf.timer.stage("prob.job"):
        processed = _process_job(sample_paths, clf, out_dir, force,
                                 progress_bar)
    clf.timer.report()
    return processed


def _process_job(sample_paths, clf: Classifier, out_dir, force: bool,
                 progress_bar: bool):
    sample_paths = [Path(p) for p in sample_paths]
    csv_paths = {}
    skipped = set()
    todo = []
    for idx, sample_path in enumerate(sample_paths):
        csv_path = files.sample_csv_path(sample_path, out_dir, FILE_SUFFIX)
        if csv_path.is_file() and not force:
            log.warning(f"{csv_path.name} already exists, skipping")
            skipped.add(sample_path.name)
            continue
        csv_paths[idx] = csv_path
        todo.append(idx)

    results: dict[int, list] = {}  # idx -> [(roi_ids, probs) blocks]
    expected: dict[int, int] = {}

    def roi_stream():
        # lazy per-sample decode: memory stays bounded by the in-flight
        # batches; decode errors are isolated per sample. Each sample
        # ships as ONE columnar RoiBlock.
        iterator = (progress(todo, "Processing samples") if progress_bar
                    else todo)
        for idx in iterator:
            try:
                rois = ifcb.read_sample(sample_paths[idx])
            except ValueError:
                log.exception(f"Faulty raw data for {sample_paths[idx].name}")
                continue
            except Exception:
                log.exception(f"Unexpected error for {sample_paths[idx].name}")
                continue
            results.setdefault(idx, [])
            expected[idx] = len(rois)
            yield pack.RoiBlock(
                sample_idx=idx, roi_ids=rois.roi_ids, heights=rois.heights,
                widths=rois.widths, offsets=rois.starts, base=rois.roi_data,
            )

    # CSV writes overlap classification: a sample flushes on a writer
    # thread the moment its last ROI drains from the device
    flushed: set[int] = set()  # only the main thread mutates this
    with ThreadPoolExecutor(max_workers=2) as writer:
        futures = []

        def flush(idx):
            with clf.timer.stage("prob.csv_write"):
                probabilities_to_csv(sorted_rows(results[idx]), clf.classes,
                                     csv_paths[idx])
            return sample_paths[idx].name

        for idx in completed_samples(clf.classify_blocks(roi_stream()),
                                     results, expected):
            flushed.add(idx)
            futures.append(writer.submit(flush, idx))
        # the job's close: zero-ROI samples and any stragglers, then the
        # writers' join
        with clf.timer.stage("prob.job_close"):
            for idx in results:
                if idx not in flushed:
                    futures.append(writer.submit(flush, idx))
            writer.shutdown(wait=True)
            written = {f.result() for f in futures}
    return written | skipped


def completed_samples(blocks, results: dict, expected: dict):
    """Spread :meth:`Classifier.classify_blocks`' per-batch ``blocks`` over
    their samples (``results[idx]`` gets each ``(roi_ids, probs)`` part) and
    yield each sample index once all ``expected[idx]`` of its ROIs are in.
    ``results`` and ``expected`` are filled by the ROI stream as it goes."""
    counts: dict[int, int] = {}
    for sidx, rids, probs in blocks:
        for u in np.unique(sidx):
            m = sidx == u
            u = int(u)
            results[u].append((rids[m], probs[m]))
            counts[u] = counts.get(u, 0) + int(m.sum())
            if counts[u] == expected[u]:
                yield u


def sorted_rows(parts):
    """``(roi_ids, probs)`` blocks of one sample -> one roi-sorted
    ``(roi_ids (n,), probs (n, C))`` pair, the array form of
    :func:`probabilities_to_csv`."""
    if not parts:
        return np.zeros(0, np.int64), np.zeros((0, 0))
    rids = np.concatenate([p[0] for p in parts])
    probs = np.concatenate([p[1] for p in parts])
    order = np.argsort(rids, kind="stable")
    return rids[order], probs[order]


def process_images(img_paths, clf: Classifier, csv_path, force: bool = False):
    """Classify loose PNG images (reference ``probability.py:165-177``)."""
    csv_path = Path(csv_path)
    if csv_path.is_file():
        if force:
            log.warning(f"{csv_path.name} already exists, overwriting")
        else:
            log.warning(f"{csv_path.name} already exists, skipping")
            return
    results = sorted(
        (roi_id, probs)
        for _, roi_id, probs in clf.classify_rois(_read_images(img_paths))
    )
    probabilities_to_csv(results, clf.classes, csv_path)


def _read_images(img_paths):
    """``(0, roi id, gray uint8)`` per readable PNG: the ROI id is the last
    ``_`` field of the stem; colour is reduced as ``cv2.cvtColor(BGR2GRAY)``
    reduces it (``sykepic_tpu/compute/probability.py:346-361``), with the
    same warning when it was not gray."""
    for path in img_paths:
        path = Path(path)
        roi_id = int(path.stem.split("_")[-1])
        try:
            img = png.decode_png_channels(path.read_bytes(), path)
        except (OSError, ValueError):
            log.warning(f"Cannot read image {path}")
            continue
        if img.shape[2] > 1:
            # IFCB images are grayscale; color PNGs are reduced to luma.
            # cv2 hands JAX B, G, R: it compares B with G
            if not (img[..., 2] == img[..., 1]).all():
                log.warning(f"{path.name} is not grayscale; using luminance")
        yield 0, roi_id, png.to_gray(img, "cvtcolor")


def probabilities_to_csv(probabilities, classes, csv_path) -> None:
    """Exact CSV contract of reference ``probability.py:200-206``.

    The row body is formatted by the native C++ helper when it builds; the
    Python fallback produces identical bytes.
    """
    csv_path = Path(csv_path)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    header = "roi," + ",".join(classes) + "\n"
    if isinstance(probabilities, tuple):
        # array form: (roi_ids (n,), probs (n, C)), already roi-sorted
        roi_ids = np.asarray(probabilities[0], np.int64)
        probs = np.asarray(probabilities[1], np.float64)
    else:
        probabilities = list(probabilities)
        roi_ids = np.asarray([r for r, _ in probabilities], np.int64)
        probs = np.asarray(
            [np.asarray(p, np.float64) for _, p in probabilities],
            np.float64,
        ) if probabilities else np.zeros((0, 0))
    if len(roi_ids):
        body = native.format_probs(roi_ids, probs)
        if body is not None:
            csv_path.write_bytes(header.encode() + body)
            return
    lines = [header.rstrip("\n")]
    for roi, row in zip(roi_ids.tolist(), probs):
        lines.append(f"{roi}," + ",".join(f"{p:.5f}" for p in row))
    csv_path.write_text("\n".join(lines) + "\n")
