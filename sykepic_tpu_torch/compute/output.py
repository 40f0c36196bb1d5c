"""Shared output contract of the aggregate post-processing commands
(``class`` / ``size`` / ``abundance`` / ``class_stats`` /
``features_per_prediction``); a copy of ``sykepic_tpu/compute/output.py``.

Every one of these commands writes ONE aggregate CSV built from a tree of
per-sample CSVs and shares the same file semantics (reference
``classification.py:29-34`` et al.): the target must name a ``.csv`` file,
an existing target requires ``--append`` (extend, header only on create)
or ``--force`` (overwrite), and per-sample build errors are isolated so
one faulty sample cannot abort a season-long aggregation. This module is
the single home for those rules.

tqdm is optional here (a GPU host may lack it): :func:`progress` wraps an
iterable in a progress bar only where tqdm imports.
"""

from __future__ import annotations

from pathlib import Path

from ..utils import logger

log = logger.get_logger("output")


def progress(iterable, desc: str):
    """``tqdm`` over ``iterable`` where it is installed, else as is."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc)


def resolve_output(path, append: bool = False, force: bool = False) -> Path:
    """Validate an aggregate-output target and return it as a ``Path``.

    Raises ``ValueError`` for a non-``.csv`` name and ``FileExistsError``
    when the target exists without ``append``/``force`` (the reference's
    skip-if-exists idempotency, ``classification.py:29-34``).
    """
    out = Path(path)
    if out.suffix != ".csv":
        raise ValueError(f"Output must be a .csv file, got {out.name}")
    if out.is_file() and not (append or force):
        raise FileExistsError(
            f"{out} already exists; pass --append or --force"
        )
    return out


def write_frame(df, out_file, append: bool = False, as_int: bool = False,
                na_rep=None) -> None:
    """Write (or extend) the aggregate frame. The header is written only
    when the file is created; ``as_int`` casts the whole frame (abundance
    tables are counts, reference ``abundance.py:99-103``)."""
    out = Path(out_file)
    if as_int:
        df = df.astype(int)
    extend = append and out.is_file()
    kwargs = {} if na_rep is None else {"na_rep": na_rep}
    df.to_csv(out, mode="a" if extend else "w", header=not extend, **kwargs)


def csv_tree(root) -> list[Path]:
    """Sorted recursive listing of the per-sample CSVs under a tree root
    (the date-sharded ``YYYY/MM/DD`` layout of :mod:`..utils.files`)."""
    return sorted(Path(root).glob("**/*.csv"))


def matched_sample_results(pairs, build, desc: str | None = None):
    """Run ``build(prob_csv, feat_csv, sample)`` over stem-matched CSV
    pairs, yielding ``(sample, result)`` per success.

    - a pair whose stems disagree aborts (the trees are misaligned — a
      wrong join would silently blend two samples' data);
    - a sample whose ``build`` raises ``KeyError`` (malformed columns) is
      logged and skipped, isolating faults per sample;
    - ``desc`` adds a progress bar.
    """
    iterator = progress(pairs, desc) if desc else pairs
    for prob_csv, feat_csv in iterator:
        sample = prob_csv.with_suffix("").stem
        if sample != feat_csv.with_suffix("").stem:
            raise ValueError(
                f"probability/feature trees are misaligned: {prob_csv.name} "
                f"paired with {feat_csv.name}"
            )
        try:
            yield sample, build(prob_csv, feat_csv, sample)
        except KeyError:
            log.exception(f"Skipping {sample}: malformed CSV columns")
