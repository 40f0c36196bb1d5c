"""Class-frequency time series from probability CSV trees: the
``frequency`` sub-command (a copy of ``sykepic_tpu/analyze/frequency.py``;
reference ``sykepic/analyze/frequency.py``).

Known reference bug intentionally NOT replicated: the reference's
``start``/``end`` filter crashes at HEAD (``frequency.py:109`` compares
the sample's timezone-AWARE datetime against naive ``strptime`` values
-> TypeError). The comparison is in naive local terms
(``filter_csv_by_date`` strips tzinfo), matching the docstring'd intent.
pandas is imported inside the function that builds the frame.
"""

from __future__ import annotations

import datetime as _dt
from pathlib import Path

from ..compute.prediction import prediction_dataframe
from ..utils.timefmt import sample_to_datetime


def frequency_df(
    pred_dir,
    thresholds=0.0,
    start=None,
    end=None,
    hour_window=None,
    date_format="%Y-%m-%d %H:%M",
):
    """Frequency of each predicted class per sample timestamp
    (reference ``frequency.py:10-65``): rows are sample datetimes, columns
    class names, cells classification counts (NaN when absent). Only rows
    whose prediction met its threshold (``classified``) are counted."""
    matched = filter_csv_by_date(pred_dir, start, end, hour_window, date_format)
    if not matched:
        print("[INFO] No sample predictions match this time restraint.")
        return None
    print(f"[INFO] Using predictions from {len(matched)} samples")
    stamped = csv_to_df(matched, thresholds)
    accepted = stamped[stamped["classified"]].drop(columns="classified")
    return group_predictions(accepted)


def filter_df(freq_df, prediction=None, top=None):
    """Column filter: explicit classes and/or the ``top`` most frequent
    (reference ``frequency.py:68-89``)."""
    out = freq_df.loc[:, prediction] if prediction else freq_df
    if top:
        out = out[out.sum().nlargest(top).index]
    return out


def _hour_bounds(hour_window: str):
    """``"HH:MM-HH:MM"`` -> (time, time) inclusive bounds."""
    lo, hi = (part.strip() for part in hour_window.split("-"))
    fmt = "%H:%M"
    return (_dt.datetime.strptime(lo, fmt).time(),
            _dt.datetime.strptime(hi, fmt).time())


def filter_csv_by_date(
    pred_dir, start=None, end=None, hour_window=None, date_format="%Y-%m-%d %H:%M"
):
    """(csv, datetime) pairs within the date range / hour-of-day window
    (reference ``frequency.py:93-115``), sorted by path."""
    root = Path(pred_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"'{root}' is not a directory")
    after = _dt.datetime.strptime(start, date_format) if start else None
    before = _dt.datetime.strptime(end, date_format) if end else None
    window = _hour_bounds(hour_window) if hour_window else None
    matched = []
    for path in sorted(root.glob("**/*.csv")):
        stamp = sample_to_datetime(path.with_suffix("").name)
        # reference compares naive datetimes; ours are UTC-aware
        local = stamp.replace(tzinfo=None)
        if after and local < after:
            continue
        if before and local > before:
            continue
        if window and not (window[0] <= local.time() <= window[1]):
            continue
        matched.append((path, stamp))
    return matched


def csv_to_df(csv_date_list, thresholds):
    """One long frame of (timestamp, prediction, classified) rows over all
    samples (reference ``frequency.py:118-136``; the per-class probability
    columns are discarded — only the thresholded verdict is needed)."""
    import pandas as pd

    pieces = []
    for path, stamp in csv_date_list:
        preds = prediction_dataframe(path, thresholds)
        if not len(preds):
            # a zero-ROI sample's CSV is header-only: prediction_dataframe
            # skips inserting the verdict columns on an empty frame, so
            # selecting them would KeyError; the sample contributes nothing
            continue
        verdicts = preds[["prediction", "classified"]].copy()
        verdicts.insert(0, "timestamp", stamp)
        pieces.append(verdicts)
    if not pieces:
        # classified must be bool-typed: indexing with an empty OBJECT
        # series would select columns, not rows
        return pd.DataFrame({
            "timestamp": pd.Series(dtype="object"),
            "prediction": pd.Series(dtype="object"),
            "classified": pd.Series(dtype="bool"),
        })
    merged = pd.concat(pieces)
    merged["prediction"] = merged["prediction"].astype("category")
    return merged


def group_predictions(df):
    """timestamp x prediction counts (reference ``frequency.py:138-142``)."""
    counts = (
        df.groupby("timestamp", observed=False).prediction.value_counts().unstack()
    )
    counts.columns.name = ""
    counts.index.name = ""
    return counts
