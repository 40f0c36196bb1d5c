"""Threshold evaluation and per-class threshold search: the ``evaluate``
sub-command (a copy of ``sykepic_tpu/analyze/evaluation.py``; reference
``sykepic/analyze/evaluation.py``).

Semantics preserved exactly:

- evaluation files are ``<sample>.select.csv`` with ``roi,actual`` rows
  (``evaluation.py:73-95``),
- classification result logic: tp on match (tn == tp for the ``empty``
  class), fp to the predicted class when actual is ``empty``, fn to the
  actual class when prediction is ``empty``, and BOTH fp+fn on a wrong real
  class (``:168-184``); support intentionally double-counts those rows
  (``:187-208`` comment),
- threshold grid search over ``arange(0, 1+p, p)`` with confidence-vs-
  threshold masking (``:53-61,109-120``), ``best_thresholds`` picks the
  criteria-maximizing row per class (``:215-220``),
- non-search mode adds the combined ``all`` row and a ``threshold`` column;
  search mode drops ``specificity``.

The reference loops rows x thresholds x score cells in Python. Here each
row contributes step functions of the threshold,
so the grid search accumulates range-sums per class in
O(rows + classes x grid), and the precision/recall/F1/support/specificity
columns are computed as whole-array expressions instead of a per-row
``DataFrame.apply``. pandas is imported inside the functions that build
frames.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np

from ..compute.prediction import prediction_dataframe, threshold_dictionary

SCORE_COLUMNS = ("precision", "recall", "F1", "support", "specificity")


def parse_evaluations(
    evaluations,
    pred_dir,
    thresholds=None,
    threshold_search=False,
    search_precision=0.01,
    empty="unclassifiable",
    ignore=None,
):
    """Evaluation files + prediction CSVs -> per-class score frame
    (reference ``evaluation.py:9-70``)."""
    eval_df, samples = read_evaluations(evaluations)
    prob_csvs = []
    for sample in samples:
        hits = Path(pred_dir).rglob(f"{sample}.prob.csv")
        try:
            prob_csvs.append(next(hits))
        except StopIteration:
            print(f"[ERROR] Cannot find prediction files for {sample}")
            raise
    if threshold_search:
        thresholds = 0.0  # argmax predictions; the grid applies afterwards
    elif not thresholds:
        raise ValueError("Thresholds not provided")
    if isinstance(thresholds, (str, Path)):
        thresholds = threshold_dictionary(thresholds)
    pred_df = prediction_dataframe(prob_csvs, thresholds)
    grid = np.arange(0, 1 + search_precision, search_precision)
    ignore_list = ignore if isinstance(ignore, list) else [ignore]
    scored = results_as_df(
        eval_df, pred_df, thresholds, threshold_search, grid, empty, ignore_list
    )
    if threshold_search:
        scored = scored.drop(columns="specificity")
    return scored


def read_evaluations(evaluations):
    """``*.select.csv`` files -> (multi-indexed frame, sample names)
    (reference ``:73-95``)."""
    import pandas as pd

    if isinstance(evaluations, (str, Path)):
        top = Path(evaluations)
        evaluations = list(top.rglob("*.select.csv")) if top.is_dir() else [top]
    if not evaluations:
        raise FileNotFoundError("[ERROR] No evaluation files found")
    frames = []
    samples = []
    for path in evaluations:
        name = Path(path).with_suffix("").with_suffix("").name
        samples.append(name)
        table = pd.read_csv(path, header=None, names=["roi", "actual"])
        table.insert(0, "sample", name)
        frames.append(table.set_index(["sample", "roi"]))
    return pd.concat(frames), samples


def _row_ingredients(eval_df, pred_df, ignore):
    """(prediction, actual, confidence) arrays for every labeled ROI that
    survives the ``ignore`` filter. Confidence = probability of the
    predicted class, gathered with one take along the class axis instead
    of O(rows) pandas ``.iloc`` lookups."""
    rows = eval_df.join(pred_df, how="inner")
    preds = rows["prediction"].astype(str).to_numpy()
    actual = rows["actual"].astype(str).to_numpy()
    col_of = {c: i for i, c in enumerate(rows.columns)}
    gather = np.array([col_of[p] for p in preds], dtype=np.int64)
    conf = rows.to_numpy()[np.arange(len(rows)), gather].astype(np.float64)
    skip = [c for c in ignore if c is not None]
    keep = ~(np.isin(preds, skip) | np.isin(actual, skip))
    return preds[keep], actual[keep], conf[keep]


def _single_threshold_counts(preds, actual, conf, thres_dict, empty):
    """Per-class tp/tn/fp/fn at each class's own threshold. A plain-argmax
    fallback prediction can name a class absent from the thresholds file;
    it is treated as threshold 0 instead of crashing (the reference
    raises KeyError there, ``:113``)."""
    import pandas as pd

    if isinstance(thres_dict, dict):
        cutoffs = np.array([thres_dict.get(p, 0.0) for p in preds])
    else:
        cutoffs = np.full(len(preds), float(thres_dict))
    effective = np.where(conf >= cutoffs, preds, empty)
    tallies = {slot: Counter() for slot in ("tp", "fp", "fn")}
    for p, a in zip(effective, actual):
        for cls, slot in classification_result(p, a, empty):
            tallies[slot][cls] += 1
    classes = sorted(set().union(*tallies.values()))
    return pd.DataFrame(
        {
            "tp": [tallies["tp"][c] for c in classes],
            "tn": 0,
            "fp": [tallies["fp"][c] for c in classes],
            "fn": [tallies["fn"][c] for c in classes],
        },
        index=classes,
    )


def _grid_search_counts(preds, actual, conf, grid, empty):
    """Per-(class, threshold) tp/fp/fn over the whole grid at once: each
    row's contribution is a step function of the threshold with the
    switch at its confidence, so accumulating the two half-ranges per row
    reproduces the reference's rows x thresholds loop in
    O(rows + classes x grid)."""
    import pandas as pd

    classes = sorted(set(preds) | set(actual))
    slot = {c: i for i, c in enumerate(classes)}
    shape = (len(classes), len(grid))
    tp = np.zeros(shape, np.int64)
    fp = np.zeros(shape, np.int64)
    fn = np.zeros(shape, np.int64)
    for p, a, cf in zip(preds, actual, conf):
        k = int(np.searchsorted(grid, cf, side="right"))  # grid[:k] <= cf
        if p == a:
            tp[slot[p], :k] += 1
            fn[slot[a], k:] += 1
        elif a == empty:
            fp[slot[p], :k] += 1
            tp[slot[a], k:] += 1  # empty==empty counts as its tp/tn
        else:
            fp[slot[p], :k] += 1
            fn[slot[a], :] += 1
    index = pd.MultiIndex.from_product([classes, grid.astype(float)])
    return pd.DataFrame(
        {"tp": tp.reshape(-1), "tn": 0,
         "fp": fp.reshape(-1), "fn": fn.reshape(-1)},
        index=index,
    )


def results_as_df(
    eval_df, pred_df, thres_dict, threshold_search, search_range, empty, ignore
):
    """tp/tn/fp/fn (+scores) per class (and per threshold in search mode),
    reference ``:98-165``."""
    import pandas as pd

    preds, actual, conf = _row_ingredients(eval_df, pred_df, ignore)

    if threshold_search:
        result_df = _grid_search_counts(
            preds, actual, conf, np.asarray(search_range), empty
        )
        if empty in result_df.index.get_level_values(0):
            result_df = result_df.drop(index=empty, level=0)
    else:
        result_df = _single_threshold_counts(
            preds, actual, conf, thres_dict, empty
        )
        # fold the empty pseudo-class into a leading combined "all" row:
        # its tp count is the true-negative total (reference ``:138-148``)
        if empty in result_df.index:
            tn_total = int(result_df.loc[empty, "tp"])
            per_class = result_df.drop(index=empty)
            combined = pd.DataFrame(
                [[per_class["tp"].sum(), tn_total,
                  per_class["fp"].sum(), per_class["fn"].sum()]],
                index=["all"], columns=["tp", "tn", "fp", "fn"],
            )
            result_df = pd.concat([combined, per_class])
        if isinstance(thres_dict, dict):
            cutoff_col = [thres_dict.get(c, np.nan) for c in result_df.index]
        else:
            cutoff_col = [thres_dict] * len(result_df)
        result_df.insert(0, "threshold", cutoff_col)

    counts = [result_df[c].to_numpy(np.float64) for c in ("tp", "tn", "fp", "fn")]
    score_df = pd.DataFrame(
        dict(zip(SCORE_COLUMNS, _vector_scores(*counts))), index=result_df.index
    )
    score_df["support"] = score_df["support"].astype(int)
    return pd.concat((result_df, score_df), axis=1)


def classification_result(predicted, actual, empty):
    """(class, tp/fp/fn) contributions of one ROI (reference ``:168-184``):
    a wrong real-class prediction charges BOTH an fp and an fn."""
    if predicted == actual:
        return ((predicted, "tp"),)
    if actual == empty:
        return ((predicted, "fp"),)
    if predicted == empty:
        return ((actual, "fn"),)
    return ((predicted, "fp"), (actual, "fn"))


def _vector_scores(tp, tn, fp, fn):
    """The five score columns as whole-array expressions
    (semantics of reference ``:187-208``)."""
    has_tp = tp > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(has_tp, tp / np.maximum(tp + fp, 1), 0.0)
        recall = np.where(has_tp, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(has_tp, F_score(precision, recall), 0.0)
        specificity = np.where(tn != 0, tn / np.maximum(tn + fp, 1), np.nan)
    # support double-counts wrong-class rows (fp AND fn) on purpose; tn
    # joins it only where a tn count exists (the "all" row)
    support = tp + fp + fn + np.where(tn != 0, tn, 0)
    return precision, recall, f1, support, specificity


def classification_scores(tp, tn, fp, fn):
    """Scalar (precision, recall, F1, support, specificity)
    (reference ``:187-208``)."""
    scalars = _vector_scores(*(np.asarray([v], np.float64)
                               for v in (tp, tn, fp, fn)))
    p, r, f1, support, spec = (float(a[0]) for a in scalars)
    return (p, r, f1, support, spec)


def F_score(precision, recall, beta=1):
    b2 = beta * beta
    return (1 + b2) * (precision * recall) / (b2 * precision + recall)


def best_thresholds(result_df, criteria="F1"):
    """Rows maximizing ``criteria`` per class (reference ``:215-220``)."""
    winners = [group[criteria].idxmax()
               for _, group in result_df.groupby(level=0)]
    return result_df.loc[winners]
