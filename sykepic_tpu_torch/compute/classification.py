"""Join predictions and features into final classification results: the
``class`` sub-command (a copy of ``sykepic_tpu/compute/classification.py``;
reference ``sykepic/compute/classification.py``).

Output contract (asserted by reference ``tests/test_classification.py:30-37``):
one row per sample of the chosen summary feature per class, a merged
Dolichospermum-Anabaenopsis column, a summed "Filamentous cyanobacteria"
column before Total, ISO-8601 Time index, underscores turned into spaces.

The JAX package's deliberate departures from the reference, kept here:

- The reference HEAD's ``swell_df`` (``classification.py:138-155``) refers to
  class names spelled ``Dolichospermum-Anabaenopsis_coiled`` /
  ``Nodularia_spumigena-coiled`` which do not exist in its own fixtures (the
  real checkpoint uses ``Dolichospermum-Anabaenopsis-coiled``; there is no
  Nodularia coiled class), and no longer merges the Doli pair even though its
  own test asserts the merged 52-column layout. The test-asserted behavior
  is implemented, and either spelling is accepted.
- ``divide_row`` (``classification.py:251-273``) iterates every bound without
  breaking, so the *last* matching bound always wins and values below the
  first bound are misfiled into the last band. Here the binning is correct
  (``np.searchsorted``) and the reference's column naming is kept
  (``names_of_divisions``).
- Taxon corrections are kept verbatim: Nodularia-coiled biomass ÷ 2.15 below
  200k µm³ biovolume else fixed 36431/volume/1000 (``:13-15,188-189``);
  Dolichospermum-coiled ÷ 7.056 (``:12,229-237``).

pandas is imported inside the functions that use it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ingest.ifcb import filter_out_quality_flagged_samples
from ..utils import logger
from ..utils.timefmt import sample_to_datetime
from .output import progress
from .prediction import prediction_dataframe, threshold_dictionary

DOLI_COILED_FACTOR_V2 = 7.056

NODU_COILED_FACTOR = 2.15
NODU_COILED_BIG_BV = 36431
NODU_COILED_BV_THRESHOLD = 200000

# Both spellings seen across reference code and fixtures
DOLI = "Dolichospermum-Anabaenopsis"
DOLI_COILED_NAMES = (
    "Dolichospermum-Anabaenopsis-coiled",
    "Dolichospermum-Anabaenopsis_coiled",
)
NODU = "Nodularia_spumigena"
NODU_COILED_NAMES = (
    "Nodularia_spumigena-coiled",
    "Nodularia_spumigena_coiled",
)
APHA = "Aphanizomenon_flosaquae"

log = logger.get_logger("class")


def main(args):
    """CLI adapter (reference ``classification.py:21-48``)."""
    from .output import csv_tree, resolve_output

    out_path = resolve_output(args.out, args.append, args.force)
    prob_csvs = csv_tree(args.probabilities)
    if args.exclusion_list:
        prob_csvs = filter_out_quality_flagged_samples(
            prob_csvs, Path(args.exclusion_list)
        )
    if args.feat:
        table = class_df(
            prob_csvs,
            csv_tree(args.feat),
            thresholds_file=args.thresholds,
            divisions_file=args.divisions,
            summary_feature=args.value_column,
            progress_bar=True,
        )
    else:
        table = class_df_probs_only(prob_csvs, args.thresholds,
                                    progress_bar=True)
    df_to_csv(swell_df(table), out_path, args.append)


def match_prob_feat(probs, feats):
    """Pair prob and feat CSVs by sample stem (reference ``:65-73``).

    The reference's mismatched-count branch is an O(N*M) cross-product; a
    stem index gives the identical (feat-sorted) pairing in O(N+M).
    """
    if len(probs) != len(feats):
        by_stem = {p.with_suffix("").stem: p for p in sorted(probs)}
        return [
            (by_stem[stem], f)
            for f in sorted(feats)
            if (stem := f.with_suffix("").stem) in by_stem
        ]
    return list(zip(sorted(probs), sorted(feats)))


def class_df(
    probs,
    feats,
    thresholds_file,
    divisions_file=None,
    summary_feature="biomass_ugl",
    progress_bar=False,
):
    """One row per sample of ``summary_feature`` per class + Total
    (reference ``classification.py:51-106``)."""
    thresholds = threshold_dictionary(thresholds_file)
    divisions = read_divisions(divisions_file) if divisions_file else None
    pairs = match_prob_feat(probs, feats)
    if progress_bar:
        pairs = progress(pairs, f"Processing {len(feats)} samples")

    rows = []
    for prob_csv, feat_csv in pairs:
        stem = prob_csv.with_suffix("").stem
        if stem != feat_csv.with_suffix("").stem:
            raise ValueError(
                f"prob/feat pairing broke: {prob_csv.name} vs {feat_csv.name}"
            )
        try:
            summary = process_sample(prob_csv, feat_csv, thresholds, divisions)
        except KeyError:
            log.exception(stem)
            continue
        rows.append(summary[summary_feature].rename(stem))

    return _samples_to_frame(rows, summary_columns(thresholds, divisions))


def summary_columns(thresholds, divisions=None) -> list:
    """Deterministic output columns: every thresholded class (division
    parents replaced by their band names), sorted, then Total
    (reference ``classification.py:99-106``)."""
    names = set(thresholds)
    if divisions:
        names |= set(names_of_divisions(divisions))
        names -= set(divisions)
    return sorted(names) + ["Total"]


def _samples_to_frame(rows, columns) -> pd.DataFrame:
    """list of per-sample class Series (named by sample) -> (samples x
    classes) frame with absent classes zero-filled. A list, not a dict:
    duplicate sample stems in the input tree must keep one row each
    (reference emits one row per CSV)."""
    import pandas as pd

    frame = pd.concat(rows, axis=1).T if rows else pd.DataFrame()
    frame = frame.reindex(columns=columns)
    frame.index.name = "sample"
    frame.columns.name = None  # the per-sample Series index name is noise
    return frame.fillna(0)


def class_df_probs_only(probs, thresholds_file, progress_bar=False):
    """Abundance counts without features (reference ``:109-135``)."""
    thresholds = threshold_dictionary(thresholds_file)
    samples = (
        progress(probs, f"Processing {len(probs)} samples")
        if progress_bar else probs
    )
    rows = []
    for prob_csv in samples:
        try:
            predictions = prediction_dataframe(prob_csv, thresholds)
            counts = predictions.groupby(
                "prediction", observed=False
            )["classified"].sum()
        except KeyError:
            continue
        counts["Total"] = len(predictions)
        rows.append(counts.rename(prob_csv.with_suffix("").stem))
    columns = list(thresholds) + ["Total"]
    return _samples_to_frame(rows, columns).astype(int)


def swell_df(df):
    """Finalize the collective frame (test-asserted layout, see module doc)."""
    df = df.copy()
    df.index = df.index.map(lambda x: sample_to_datetime(x, isoformat=True))
    df.index.name = "Time"
    # Merge Dolichospermum-Anabaenopsis variants into one column
    doli_cols = [c for c in DOLI_COILED_NAMES if c in df.columns]
    doli_sum = df[DOLI] if DOLI in df.columns else 0.0
    for c in doli_cols:
        doli_sum = doli_sum + df[c]
    if doli_cols and DOLI in df.columns:
        df[DOLI] = doli_sum
        df.drop(columns=doli_cols, inplace=True)
    # Sum Nodularia classes (kept as separate columns)
    nodu_sum = df[NODU] if NODU in df.columns else 0.0
    for c in NODU_COILED_NAMES:
        if c in df.columns:
            nodu_sum = nodu_sum + df[c]
    # Filamentous cyanobacteria = Aphanizomenon + Dolichospermum + Nodularia
    cyano_sum = (df[APHA] if APHA in df.columns else 0.0) + doli_sum + nodu_sum
    df.insert(len(df.columns) - 1, "Filamentous cyanobacteria", cyano_sum)
    df.columns = df.columns.str.replace("_", " ")
    return df


def df_to_csv(df, out_file, append=False):
    append = append and Path(out_file).is_file()
    mode = "a" if append else "w"
    df.to_csv(out_file, mode=mode, header=not append)


def read_volume_ml(feat_csv) -> float:
    """Parse the last ``# key=value`` comment header (reference ``:168-176``)."""
    header = None
    with open(feat_csv) as fh:
        for line in fh:
            if line.startswith("#"):
                header = line
            else:
                break
    if header is None:
        raise ValueError(f"No comment header in {feat_csv}")
    return float(header[1:].strip().split("=")[1])


def join_sample(prob_csv, feat_csv, thresholds):
    """Join predictions and features on roi number (shared by the whole
    post-processing suite, reference ``:178-186``)."""
    import pandas as pd

    df = pd.concat(
        [
            prediction_dataframe(prob_csv, thresholds),
            pd.read_csv(feat_csv, index_col=0, comment="#"),
        ],
        axis=1,
    )
    df.index.name = "roi"
    return df


def process_sample(
    prob_csv, feat_csv, thresholds, divisions=None, division_column="biovolume_px"
):
    """Per-sample groupby of frequency/biovolume/biomass per predicted class
    (reference ``classification.py:164-237``)."""
    sample_volume = read_volume_ml(feat_csv)
    df = join_sample(prob_csv, feat_csv, thresholds)

    # Nodularia coiled biomass corrections (reference :13-15,188-189)
    for nodu_coiled in NODU_COILED_NAMES:
        small = (df["prediction"] == nodu_coiled) & (
            df["biovolume_um3"] < NODU_COILED_BV_THRESHOLD
        )
        big = (df["prediction"] == nodu_coiled) & (
            df["biovolume_um3"] >= NODU_COILED_BV_THRESHOLD
        )
        df.loc[small, "biomass_ugl"] /= NODU_COILED_FACTOR
        df.loc[big, "biomass_ugl"] = NODU_COILED_BIG_BV / float(sample_volume) / 1000

    # Totals recorded before dropping unclassified rows (reference :191-196)
    total_biovolume_um3 = df["biovolume_um3"].sum()
    total_biomass_ugl = df["biomass_ugl"].sum()
    total_frequency = len(df)
    df = df[df["classified"]]

    if df.isna().any(axis=1).any():
        log.warning(f"Sample with empty biovolumes: {feat_csv}")

    if divisions:
        df = df.copy()
        df["prediction"] = divide_predictions(
            df["prediction"].astype(str).to_numpy(),
            df[division_column].to_numpy(),
            divisions,
        )

    group = df.groupby("prediction", observed=False)
    gdf = group.sum()[["classified", "biovolume_um3", "biomass_ugl"]]
    gdf.rename(columns={"classified": "frequency"}, inplace=True)
    gdf.index.name = "class"
    gdf.sort_values("biomass_ugl", ascending=False, inplace=True)
    gdf.drop(gdf[gdf["frequency"] <= 0].index, inplace=True)
    gdf.loc["Total"] = [total_frequency, total_biovolume_um3, total_biomass_ugl]

    # Dolichospermum-coiled conversion factor (reference :229-237)
    for doli_coiled in DOLI_COILED_NAMES:
        if doli_coiled in gdf.index:
            gdf.loc[doli_coiled, "biovolume_um3"] /= DOLI_COILED_FACTOR_V2
            gdf.loc[doli_coiled, "biomass_ugl"] /= DOLI_COILED_FACTOR_V2
    return gdf


def read_divisions(division_file):
    """Parse ``class bound...`` lines (reference ``:241-248``)."""
    divisions = {}
    with open(division_file) as fh:
        for line in fh:
            line = line.strip().split()
            if not line:
                continue
            key, *values = line
            divisions[key] = list(map(int, values))
    return divisions


def divide_predictions(predictions, values, divisions):
    """Rename predictions into intra-class size divisions.

    Correct binning of what reference ``divide_row`` (``:251-273``) intends:
    ``under_b0`` / ``b_i_b_i+1`` / ``over_bn`` by ``values`` against each
    class's sorted bounds.
    """
    out = predictions.astype(object).copy()
    for name, bounds in divisions.items():
        bounds = sorted(bounds)
        labels = division_labels(name, bounds)
        mask = predictions == name
        if not mask.any():
            continue
        idx = np.searchsorted(np.asarray(bounds, dtype=float), values[mask], side="right")
        out[mask] = np.asarray(labels, dtype=object)[idx]
    return out


def division_labels(name, bounds):
    """Bin labels in searchsorted order: under, bands..., over."""
    labels = [f"{name}_under_{bounds[0]}"]
    for lo, hi in zip(bounds, bounds[1:]):
        labels.append(f"{name}_{lo}_{hi}")
    labels.append(f"{name}_over_{bounds[-1]}")
    return labels


def names_of_divisions(divisions):
    """All division column names (reference ``:276-284``)."""
    new_names = []
    for key, values in divisions.items():
        new_names.extend(division_labels(key, sorted(values)))
    return new_names
