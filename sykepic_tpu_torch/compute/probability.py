"""Compute class probabilities for raw IFCB data (reference
``sykepic/compute/probability.py``; the port of
``sykepic_tpu/compute/probability.py``).

Same contracts as the reference:

- input modes: raw dir / sample list (the image-input modes need a PNG
  reader and come in a later slice of the port)
- samples with a ``.roi`` over 1 GB are skipped (``:44-53``)
- per-sample error isolation: faulty raw data logs and continues (``:106-115``)
- skip-if-CSV-exists idempotency with ``force`` override (``:136-141``)
- output: ``out_dir/YYYY/MM/DD/<sample>.prob.csv`` with header
  ``roi,<classes...>`` and probabilities at 5 decimals, roi-ascending
  (``:200-206``)
- softmax temperature ``ln(1.3)`` inside the engine (``:18,191-194``)

ROIs decode straight from the ``.roi`` payload into packed device batches,
and ROIs of different samples share device batches.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..ingest import ifcb, native, pack
from ..utils import files, logger
from .engine import Classifier

FILE_SUFFIX = ".prob"
MAX_ROI_BYTES = 1e9
log = logger.get_logger("prob")

_IMAGES_LATER = (
    "image inputs (--image-dir/--images) are not ported yet: they need a "
    "PNG reader and come with the port's remaining CLI (ROADMAP slice 6)")


def _progress(iterable, desc: str):
    """``tqdm`` over ``iterable`` where it is installed, else as is."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc)


def call(args):
    """CLI adapter (argument surface = reference ``probability.py:27-64``)."""
    if args.image_dir or args.images:
        raise NotImplementedError(_IMAGES_LATER)
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
    main(
        filtered,
        args.model,
        args.out,
        args.batch_size,
        args.num_workers,
        args.force,
        progress_bar=True,
        device=args.device,
    )


def main(
    sample_paths,
    model_dir,
    out_dir,
    batch_size: int = 64,
    num_workers: int = 2,  # accepted for CLI parity; host feed is threaded
    force: bool = False,
    progress_bar: bool = True,
    classifier: Classifier | None = None,
    device=None,
):
    """Classify samples and write one ``.prob.csv`` per sample on
    ``device`` (``cuda`` unless the caller asks for ``cpu``).

    Returns the set of sample names processed (reference ``:105-115``).
    """
    clf = classifier or prepare_model(
        model_dir, batch_size=max(batch_size, 1), device=device)
    return process_samples_batched(
        sample_paths, clf, out_dir, force, progress_bar=progress_bar)


def prepare_model(model_dir, batch_size: int = 256, dtype: str = "float32",
                  device=None):
    """Load the model directory into a ready :class:`Classifier`
    (reference ``probability.py:118-130``)."""
    return Classifier(model_dir, batch_size=batch_size, dtype=dtype,
                      device=device)


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
    counts: dict[int, int] = {}
    expected: dict[int, int] = {}

    def roi_stream():
        # lazy per-sample decode: memory stays bounded by the in-flight
        # batches; decode errors are isolated per sample. Each sample
        # ships as ONE columnar RoiBlock.
        iterator = (_progress(todo, "Processing samples") if progress_bar
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
            parts = results[idx]
            if parts:
                rids = np.concatenate([p[0] for p in parts])
                probs = np.concatenate([p[1] for p in parts])
                order = np.argsort(rids, kind="stable")  # roi-sorted CSV
                rows = (rids[order], probs[order])
            else:
                rows = (np.zeros(0, np.int64), np.zeros((0, 0)))
            probabilities_to_csv(rows, clf.classes, csv_paths[idx])
            return sample_paths[idx].name

        for sidx, rids, probs in clf.classify_blocks(roi_stream()):
            for u in np.unique(sidx):
                m = sidx == u
                u = int(u)
                results[u].append((rids[m], probs[m]))
                counts[u] = counts.get(u, 0) + int(m.sum())
                if counts[u] == expected[u]:
                    flushed.add(u)
                    futures.append(writer.submit(flush, u))
        # zero-ROI samples and any stragglers
        for idx in results:
            if idx not in flushed:
                futures.append(writer.submit(flush, idx))
        written = {f.result() for f in futures}
    return written | skipped


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
