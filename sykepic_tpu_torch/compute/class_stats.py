"""Per-class feature statistics: the ``class_stats`` sub-command (a copy of
``sykepic_tpu/compute/class_stats.py``; reference
``sykepic/compute/class_stats.py``).

Joins predictions and features per sample, filters to requested classes and
aggregates mean/median/min/max of biovolume_um3 / area / major and minor
axis lengths per predicted class; the column MultiIndex is flattened with
``_`` (reference ``class_stats.py:79-115``). pandas is imported inside the
function that concatenates the frames.
"""

from __future__ import annotations

from .classification import join_sample, match_prob_feat
from .output import csv_tree, matched_sample_results, resolve_output, write_frame
from .prediction import threshold_dictionary

STAT_FEATURES = ["biovolume_um3", "area", "major_axis_length", "minor_axis_length"]
STATS = ["mean", "median", "min", "max"]


def main(args):
    """CLI adapter (argument surface = reference ``class_stats.py:10-30``)."""
    out_file = resolve_output(args.out, args.append, args.force)
    if not args.feat:
        raise ValueError(
            "class_stats needs --feat: the statistics summarize feature "
            "columns (biovolume/area/axes)"
        )
    df = class_df(
        csv_tree(args.probabilities),
        csv_tree(args.feat),
        args.classes,
        thresholds_file=args.thresholds,
        progress_bar=True,
    )
    write_frame(df, out_file, args.append)


def class_df(probs, feats, classes, thresholds_file, progress_bar=False):
    """Concatenated per-sample stats frames (reference ``:32-72``)."""
    import pandas as pd

    thresholds = threshold_dictionary(thresholds_file)
    frames = matched_sample_results(
        match_prob_feat(probs, feats),
        lambda p, f, sample: process_sample(p, f, thresholds, sample, classes),
        desc=f"Processing {len(feats)} samples" if progress_bar else None,
    )
    return pd.concat([frame for _, frame in frames])


def process_sample(prob_csv, feat_csv, thresholds, sample, classes):
    """Stats over classified ROIs of one sample (reference ``:79-115``)."""
    df = join_sample(prob_csv, feat_csv, thresholds)
    df = df[df["classified"]]
    df_stats = df[["prediction", "classified"] + STAT_FEATURES]
    if classes:
        df_stats = df_stats[df_stats["prediction"].isin(classes)]
    stats = df_stats.groupby("prediction", observed=False).agg(
        {feature: STATS for feature in STAT_FEATURES}
    )
    stats.columns = stats.columns.map("_".join)
    stats = stats.dropna()
    stats.index.name = "class"
    stats.insert(0, "sample", sample)
    return stats
