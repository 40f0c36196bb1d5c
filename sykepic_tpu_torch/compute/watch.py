"""Continuous monitoring mode: ``sykepic-tpu-torch watch`` polls a raw
directory and processes new IFCB samples as the instrument writes them
(fused classify+features per sample, through the host-thread ``pipeline``).
The port of ``sykepic_tpu/compute/watch.py``: the poll loop, its backoff,
its systemic-failure streak and its give-up rule are the JAX package's.

The reference is batch-only (run ``sykepic prob``/``feat`` by hand or cron);
this daemon is the deployment shape the pipeline actually runs in at a
monitoring station: the model stays loaded on one card (no per-invocation
start-up cost), outputs are idempotent (existing CSVs skip), and a sample is
only picked up once its ``.roi`` stops growing (the instrument writes for ~20
minutes per sample).
"""

from __future__ import annotations

import time

from ..utils import files, logger
from . import feature_native, pipeline, probability

log = logger.get_logger("watch")


def call(args):
    """CLI adapter: one classifier on ``--device`` (cuda by default), no
    mesh."""
    clf = probability.prepare_model(args.model, batch_size=args.batch_size,
                                    device=args.device)
    run(
        args.raw,
        clf,
        args.out,
        feat_out_dir=args.feat_out or args.out,
        interval=args.interval,
        settle_seconds=args.settle,
        max_cycles=None,
    )


def find_ready_samples(raw_dir, settle_seconds: float = 60.0):
    """Sample paths whose raw triplet is complete and whose ``.roi`` has not
    been modified for ``settle_seconds`` (still being written otherwise)."""
    now = time.time()
    ready = []
    for sample_path in files.list_sample_paths(raw_dir):
        roi = sample_path.with_suffix(".roi")
        adc = sample_path.with_suffix(".adc")
        hdr = sample_path.with_suffix(".hdr")
        if not (adc.is_file() and hdr.is_file()):
            continue
        try:
            st = roi.stat()
        except FileNotFoundError:
            continue
        if now - st.st_mtime >= settle_seconds:
            ready.append(sample_path)
    return sorted(ready)


def run(
    raw_dir,
    clf,
    prob_out_dir,
    feat_out_dir=None,
    interval: float = 30.0,
    settle_seconds: float = 60.0,
    max_cycles: int | None = None,
    max_retries: int = 3,
    sleep=time.sleep,
):
    """Poll loop. ``max_cycles``/``sleep`` are injectable for tests.

    Failure policy (a corrupt .roi must not be re-decoded for the daemon's
    lifetime, but an infrastructure outage must not abandon healthy
    pending samples either):

    - a failed attempt schedules the sample's next attempt with
      exponential backoff (``2**failures * interval``), so the
      ``max_retries`` attempts span a window much longer than a transient
      device/link blip instead of three back-to-back poll cycles;
    - a cycle in which EVERY attempted sample (>= 2 of them) failed bears
      the signature of a systemic outage, not per-sample corruption, and
      does not count toward any sample's retry budget — but only for a
      bounded streak: after ``systemic_tolerance`` consecutive all-failed
      cycles over the SAME sample set, per-sample counting resumes
      (otherwise two corrupt samples fail together forever, each
      re-decoded every cycle for the daemon's lifetime — the exact
      pathology the retry budget exists to stop);
    - a sample is abandoned (marked done, logged) after ``max_retries``
      counted failures.

    Returns the set of sample names processed over the run.
    """
    feat_out_dir = feat_out_dir or prob_out_dir
    systemic_tolerance = 10
    done: set[str] = set()
    failures: dict[str, int] = {}  # counted failed attempts per sample
    next_attempt: dict[str, float] = {}  # backoff deadline per sample
    systemic_streak = 0
    systemic_set: frozenset[str] = frozenset()
    cycles = 0
    while True:
        try:
            now = time.time()
            ready = [
                p for p in find_ready_samples(raw_dir, settle_seconds)
                if p.name not in done
                and next_attempt.get(p.name, 0.0) <= now
            ]
            # same oversize guard as the prob/feat/pipeline CLIs (reference
            # feature_python.py:22-28): never decode a >1 GB .roi in-process
            def _roi_size(p):
                try:
                    return p.with_suffix(".roi").stat().st_size
                except FileNotFoundError:
                    # deleted between find_ready_samples and here: treat as
                    # not ready rather than aborting the whole cycle
                    return -1

            oversized = [
                p for p in ready if _roi_size(p) > probability.MAX_ROI_BYTES
            ]
            for p in oversized:
                log.warning(f"{p.name} .roi is over 1 GB, skipping for good")
            done |= {p.name for p in oversized}
            ready = [p for p in ready if p.name not in done]
            if ready:
                log.info(f"Processing {len(ready)} new sample(s)")
                processed = pipeline.main(
                    ready, clf, prob_out_dir, feat_out_dir=feat_out_dir
                )
                # only successfully processed samples (or ones with BOTH
                # output CSVs already on disk) are done — transient failures
                # retry on the next cycle instead of being dropped for the
                # daemon's lifetime
                done |= processed
                done |= {
                    p.name for p in ready
                    if files.sample_csv_path(
                        p, prob_out_dir, probability.FILE_SUFFIX
                    ).is_file()
                    and files.sample_csv_path(
                        p, feat_out_dir, feature_native.FILE_SUFFIX
                    ).is_file()
                }
                failed = [p for p in ready if p.name not in done]
                for p in ready:
                    if p.name in done:
                        failures.pop(p.name, None)
                        next_attempt.pop(p.name, None)
                failed_set = frozenset(p.name for p in failed)
                systemic = (failed and len(failed) == len(ready)
                            and len(ready) > 1)
                if systemic and failed_set == systemic_set:
                    systemic_streak += 1
                else:
                    systemic_streak = 1 if systemic else 0
                    systemic_set = failed_set if systemic else frozenset()
                if systemic and systemic_streak <= systemic_tolerance:
                    # every attempted sample failed: systemic signature
                    # (outage, disk full) — retry next cycle, burn no
                    # per-sample retries. A long streak over the SAME set
                    # stops qualifying (see docstring).
                    log.warning(
                        f"all {len(ready)} attempted samples failed this "
                        "cycle — treating as a systemic failure, not "
                        "counting toward per-sample retries "
                        f"(streak {systemic_streak}/{systemic_tolerance})"
                    )
                else:
                    for p in failed:
                        failures[p.name] = failures.get(p.name, 0) + 1
                        if failures[p.name] >= max_retries:
                            log.error(
                                f"{p.name} failed {max_retries} attempts "
                                "(corrupt sample?), giving up on it"
                            )
                            done.add(p.name)
                        else:
                            next_attempt[p.name] = time.time() + (
                                2 ** failures[p.name]
                            ) * interval
        except Exception:
            log.exception("watch cycle failed; continuing")
        cycles += 1
        if max_cycles is not None and cycles >= max_cycles:
            return done
        sleep(interval)
