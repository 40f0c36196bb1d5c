"""The classification report of a test run, in scikit-learn's text layout
(``sklearn.metrics.classification_report(..., labels=..., target_names=...,
zero_division=0)``, which the JAX package's ``train/loop.py::test_net``
prints; the port does not depend on scikit-learn).

Per class: precision, recall, f1 and support; then accuracy and the macro
and weighted averages. Counts come from numpy; f1 is ``2 tp / (2 tp + fp +
fn)``, and a ratio with a zero denominator is 0.
"""

from __future__ import annotations

import numpy as np

HEADERS = ("precision", "recall", "f1-score", "support")


def _ratio(num, den):
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def scores(y_true, y_pred, n_classes: int):
    """Per-class ``(precision, recall, f1, support)`` arrays over labels
    ``0 .. n_classes - 1``."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    labels = np.arange(n_classes)
    tp = np.array([np.sum((y_true == k) & (y_pred == k)) for k in labels])
    pred = np.array([np.sum(y_pred == k) for k in labels])
    support = np.array([np.sum(y_true == k) for k in labels])
    precision = _ratio(tp, pred)
    recall = _ratio(tp, support)
    f1 = _ratio(2 * tp, 2 * tp + (pred - tp) + (support - tp))
    return precision, recall, f1, support


def classification_report(y_true, y_pred, target_names, digits: int = 2):
    """The text ``sklearn.metrics.classification_report`` writes for these
    labels and names (every prediction is one of the classes, so its micro
    average is the accuracy line)."""
    n = len(target_names)
    p, r, f1, s = scores(y_true, y_pred, n)
    total = int(s.sum())
    width = max(max(len(cn) for cn in target_names), len("weighted avg"),
                digits)
    head_fmt = "{:>{width}s} " + " {:>9}" * len(HEADERS)
    report = head_fmt.format("", *HEADERS, width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(target_names, p, r, f1, s):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    accuracy = float(np.sum(np.asarray(y_true) == np.asarray(y_pred))
                     / total) if total else 0.0
    acc_fmt = ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}"
               + " {:>9}\n")
    report += acc_fmt.format("accuracy", "", "", accuracy, total,
                             width=width, digits=digits)
    report += row_fmt.format("macro avg", p.mean(), r.mean(), f1.mean(),
                             total, width=width, digits=digits)
    weights = s if total else None
    report += row_fmt.format(
        "weighted avg", *(float(np.average(v, weights=weights))
                          for v in (p, r, f1)), total,
        width=width, digits=digits)
    return report
