"""Per-ROI feature rows for the filamentous cyanobacteria classes, chunked
into one output CSV per calendar month: the ``features_per_prediction``
sub-command (a copy of ``sykepic_tpu/compute/features_per_prediction.py``;
reference ``sykepic/compute/features_per_prediction.py``).

The month key is ``sample[5:7]`` (reference ``:80``). Output files are
numbered ``<stem>1.csv``, ``<stem>2.csv``, ... — the reference's numbering
mutates the path variable in place so names accumulate digits
(``out1``, ``out12``, ...; reference ``:31-36``); here each chunk gets a
clean single suffix. pandas is imported inside the function that
concatenates the chunks.
"""

from __future__ import annotations

from .classification import join_sample, match_prob_feat
from .output import csv_tree, matched_sample_results, resolve_output, write_frame
from .prediction import threshold_dictionary

FILAMENT_LABELS = [
    "Dolichospermum-Anabaenopsis",
    "Dolichospermum-Anabaenopsis_coiled",
    "Dolichospermum-Anabaenopsis-coiled",
    "Nodularia_spumigena",
    "Nodularia_spumigena-coiled",
    "Aphanizomenon_flosaquae",
]

FPP_FEATURES = [
    "prediction",
    "biovolume_um3",
    "biomass_ugl",
    "area",
    "major_axis_length",
    "minor_axis_length",
]


def main(args):
    """CLI adapter (argument surface = reference
    ``features_per_prediction.py:12-37``)."""
    out_file = resolve_output(args.out, args.append, args.force)
    if not args.feat:
        raise ValueError(
            "features_per_prediction needs --feat: it emits per-ROI "
            "feature rows"
        )
    chunks = class_df(
        csv_tree(args.probabilities),
        csv_tree(args.feat),
        thresholds_file=args.thresholds,
        progress_bar=True,
    )
    for number, chunk in enumerate(chunks, start=1):
        chunk_path = out_file.with_name(
            f"{out_file.stem}{number}{out_file.suffix}"
        )
        write_frame(chunk, chunk_path, args.append)


def class_df(probs, feats, thresholds_file, progress_bar=False):
    """List of month-chunk frames in sample order (reference ``:39-105``)."""
    import pandas as pd

    thresholds = threshold_dictionary(thresholds_file)
    results = matched_sample_results(
        match_prob_feat(probs, feats),
        lambda p, f, sample: process_sample(p, f, thresholds, sample),
        desc=f"Processing {len(feats)} samples" if progress_bar else None,
    )
    chunks: list[pd.DataFrame] = []
    pending: list[pd.DataFrame] = []
    pending_month = None
    for sample, frame in results:
        month = sample[5:7]
        if pending and month != pending_month:
            chunks.append(pd.concat(pending))
            pending = []
        pending_month = month
        pending.append(frame)
    if pending:
        chunks.append(pd.concat(pending))
    return chunks


def process_sample(prob_csv, feat_csv, thresholds, sample):
    """Per-ROI rows of the filamentous classes (reference ``:110-132``)."""
    df = join_sample(prob_csv, feat_csv, thresholds)
    df = df[df["classified"]]
    df_stats = df[FPP_FEATURES]
    filaments = df_stats[df_stats["prediction"].isin(FILAMENT_LABELS)].copy()
    filaments.insert(0, "sample", sample)
    return filaments
