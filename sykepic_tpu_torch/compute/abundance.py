"""Count classified ROIs per class per sample: the ``abundance``
sub-command (a copy of ``sykepic_tpu/compute/abundance.py``; reference
``sykepic/compute/abundance.py``).

The Total column is the number of ROIs in the sample (classified or not).
The reference accumulates totals in a module-level global list appended per
sample (``abundance.py:86,105,121-124``), which silently misaligns when a
sample yields an empty frame; here the total rides with its sample row.
pandas is imported inside the function that builds the frame.
"""

from __future__ import annotations

from pathlib import Path

from ..ingest.ifcb import filter_out_quality_flagged_samples
from ..utils.timefmt import sample_to_datetime
from .classification import join_sample, match_prob_feat
from .output import csv_tree, matched_sample_results, resolve_output, write_frame
from .prediction import threshold_dictionary


def main(args):
    """CLI adapter (argument surface = reference ``abundance.py:12-38``)."""
    out_file = resolve_output(args.out, args.append, args.force)
    if not args.feat:
        raise ValueError(
            "abundance needs --feat: counts only cover ROIs present in "
            "both the probability and feature trees"
        )
    probs = csv_tree(args.probabilities)
    if args.exclusion_list:
        probs = filter_out_quality_flagged_samples(
            probs, Path(args.exclusion_list)
        )
    df = class_df(
        probs,
        csv_tree(args.feat),
        thresholds_file=args.thresholds,
        summary_feature=args.value_column,
        progress_bar=True,
    )
    write_frame(swell_df(df), out_file, args.append, as_int=True)


def class_df(
    probs,
    feats,
    thresholds_file,
    summary_feature="biomass_ugl",
    progress_bar=False,
):
    """Per-sample counts of classified ROIs per class (reference ``:40-89``)."""
    import pandas as pd

    thresholds = threshold_dictionary(thresholds_file)
    rows = []
    totals = []
    results = matched_sample_results(
        match_prob_feat(probs, feats),
        lambda p, f, sample: process_sample(p, f, thresholds),
        desc=f"Processing {len(feats)} samples" if progress_bar else None,
    )
    for sample, (counts, total) in results:
        column = counts[summary_feature]
        column.name = sample
        rows.append(column)
        totals.append(total)

    classes = sorted(thresholds.keys())
    df = pd.DataFrame(rows, columns=classes + ["Total"])
    df["Total"] = totals
    df.index.name = "sample"
    return df.fillna(0)


def swell_df(df):
    """ISO timestamps, underscores to spaces (reference ``:91-97``)."""
    df = df.copy()
    df.index = df.index.map(lambda x: sample_to_datetime(x, isoformat=True))
    df.index.name = "Time"
    df.columns = df.columns.str.replace("_", " ")
    return df


def process_sample(prob_csv, feat_csv, thresholds):
    """Counts per predicted class; returns ``(counts_df, total_rois)``
    (reference ``:106-131``)."""
    df = join_sample(prob_csv, feat_csv, thresholds)
    total = len(df.index)
    df = df[df["classified"]]
    abundances = df.groupby("prediction", observed=False).count()
    abundances.index.name = "class"
    return abundances, total
