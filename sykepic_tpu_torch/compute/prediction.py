"""Thresholded predictions from class probabilities (a copy of
``sykepic_tpu/compute/prediction.py``).

This is the single semantic definition of "a classification", shared by
``classification``, ``abundance``, ``class_stats``, ``features_per_prediction``
and the analyze layer (reference ``sykepic/compute/prediction.py:8-79``).

Semantics (reference ``prediction.py:49-71``):

- dict thresholds: the winning class is the *highest-probability* class that
  is present in the thresholds dict AND whose probability is ``>=`` its own
  threshold. If no class qualifies, the plain argmax wins with
  ``classified=False``.
- scalar threshold: plain argmax, ``classified = prob > threshold`` (strict).

The whole frame is one masked argmax over a ``(rows, classes)`` ndarray
(the reference runs a Python closure per row); ties resolve to the lowest
column index. pandas is imported inside the functions that build frames.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _indexed_prob_frame(csv) -> pd.DataFrame:
    """One prob CSV as a frame with a ``(sample, roi)`` MultiIndex."""
    import pandas as pd

    frame = pd.read_csv(csv)
    frame.insert(0, "sample", Path(csv).with_suffix("").stem)
    return frame.set_index(["sample", "roi"])


def prediction_dataframe(probabilities, thresholds=0.0):
    """Probability table with ``prediction`` + ``classified`` columns
    inserted. Accepts a single CSV path (roi index), a list of CSV paths
    (``(sample, roi)`` MultiIndex) or an existing DataFrame
    (reference ``prediction.py:8-28``)."""
    import pandas as pd

    if isinstance(probabilities, pd.DataFrame):
        frame = probabilities
    elif isinstance(probabilities, list):
        frame = pd.concat(_indexed_prob_frame(p) for p in probabilities)
    elif isinstance(probabilities, (str, Path)):
        frame = pd.read_csv(probabilities, index_col=0)
    else:
        raise ValueError(
            f"probabilities must be a path, list of paths or DataFrame, "
            f"got {type(probabilities)}"
        )
    if isinstance(thresholds, (str, Path)):
        thresholds = threshold_dictionary(thresholds)
    if len(frame):
        insert_prediction(frame, thresholds)
    return frame


def threshold_dictionary(thresholds, default=None):
    """``{class: threshold}`` from a ``class value`` text file; classes
    listed without a value take ``default`` (reference
    ``prediction.py:31-46``)."""
    table: dict[str, float] = {}
    for lineno, raw in enumerate(Path(thresholds).read_text().splitlines(), 1):
        tokens = raw.split()
        if not tokens:
            continue
        name = tokens[0]
        if len(tokens) > 1:
            table[name] = float(tokens[1])
        elif default is not None:
            table[name] = float(default)
        else:
            raise ValueError(
                f"{thresholds}:{lineno}: class {name!r} has no threshold "
                "and no default was given"
            )
    return table


def predict(probs: np.ndarray, classes, thresholds):
    """Vectorized core: ``(N, C)`` probabilities -> (pred_idx, classified).

    ``thresholds`` is a scalar or a ``{class: threshold}`` dict. Returns
    ``pred_idx`` int64 array of winning column indices and ``classified``
    bool array.
    """
    probs = np.asarray(probs, dtype=np.float64)
    if probs.ndim != 2:
        raise ValueError("probs must be 2-D (rows, classes)")
    argmax = probs.argmax(axis=1)
    if isinstance(thresholds, (int, float)):
        # Scalar: argmax with strict > test (reference :57-59)
        classified = probs[np.arange(len(probs)), argmax] > thresholds
        return argmax, classified
    # Dict: mask out classes below their own threshold or absent from the
    # dict, then argmax over what survives (reference :60-71)
    thr = np.full(probs.shape[1], np.inf)
    for j, name in enumerate(classes):
        if name in thresholds:
            thr[j] = thresholds[name]
    qualified = probs >= thr
    masked = np.where(qualified, probs, -np.inf)
    classified = qualified.any(axis=1)
    pred = np.where(classified, masked.argmax(axis=1), argmax)
    return pred, classified


def insert_prediction(df, thresholds) -> None:
    """Insert ``prediction`` (category) and ``classified`` columns in place
    (reference ``prediction.py:74-79``)."""
    classes = list(df.columns)
    pred_idx, classified = predict(df.to_numpy(), classes, thresholds)
    names = np.asarray(classes, dtype=object)[pred_idx]
    df.insert(0, "prediction", names)
    df["prediction"] = df["prediction"].astype("category")
    df.insert(1, "classified", classified)


def row_prediction(row, thresholds):
    """Single-row API kept for parity (reference ``prediction.py:49-71``)."""
    probs = row.to_numpy(dtype=np.float64)[None, :]
    pred_idx, classified = predict(probs, list(row.index), thresholds)
    return (row.index[pred_idx[0]], bool(classified[0]))
