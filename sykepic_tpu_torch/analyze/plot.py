"""Plotting helpers (the port of ``sykepic_tpu/analyze/plot.py``; reference
``sykepic/analyze/plot.py``): the training curves, the class distribution
(``train --dist``), the image collage (``train --collage``), per-class time
series and single images.

Matplotlib is optional (a GPU host may lack it). :func:`available`
says whether it imports; the train loop then skips the training-curve plots
and says so once in its log, and ``train --dist`` raises. It is imported
lazily with the Agg backend, so headless training nodes never need a
display. :func:`view_batch` needs no matplotlib: it writes its PNG with
:func:`sykepic_tpu_torch.utils.png.write_png`, where the JAX package calls
``cv2.imwrite`` (the channels of a colour collage are taken as cv2's BGR,
so the file holds the same colours). The visual style (dark background,
turquoise/tomato series) follows the reference's look; appearance is not a
parity contract.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np

# series styling shared by the training-curve and distribution plots
_TRAIN_STYLE = dict(label="Training", c="turquoise", lw=2)
_VAL_STYLE = dict(label="Validation", c="tomato", lw=2)


def available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    from matplotlib import pyplot as plt

    return plt


def _style(plt, name):
    try:
        plt.style.use(name)
    except OSError:
        # matplotlib >= 3.6 renamed the seaborn styles
        if name.startswith("seaborn"):
            plt.style.use(name.replace("seaborn", "seaborn-v0_8"))


def class_plot(class_csv, columns_to_plot, ylabel="Biomass (μg/L)",
               out_file=None):
    """Per-class time series from a classification CSV
    (reference ``plot.py:14-37``; timestamps shown in Helsinki time)."""
    import pandas as pd

    plt = _plt()
    from matplotlib import units as munits
    from matplotlib.dates import ConciseDateConverter

    munits.registry[datetime.datetime] = ConciseDateConverter()
    _style(plt, "seaborn-whitegrid")
    table = pd.read_csv(class_csv)
    table["Time"] = pd.to_datetime(table.Time).dt.tz_convert("Europe/Helsinki")
    if isinstance(columns_to_plot[0], int):
        columns_to_plot = [table.columns[i] for i in columns_to_plot]
    fig, axes = plt.subplots(
        len(columns_to_plot), 1, figsize=(15, 10), sharex=True,
        constrained_layout=True,
    )
    fig.text(-0.02, 0.5, ylabel, va="center", rotation="vertical", size=14)
    for ax, column in zip(np.atleast_1d(axes), columns_to_plot):
        ax.set_title(column.replace("_", " "), fontsize=14)
        ax.plot(table.Time, table[column])
    target = Path(out_file) if out_file else Path(class_csv).with_suffix(".png")
    plt.savefig(target, format="png", bbox_inches="tight")
    plt.close()
    return target


def view_batch(images, h=None, w=None, save=None):
    """Save an ``h x w`` collage of a batch (reference ``plot.py:40-72``).

    ``images``: (B, H, W, C) or (B, H, W) float array in [0, 1], C 1 or 3
    (3: BGR, as cv2 takes it). When only one of ``h``/``w`` is given the
    other is derived from the batch size; with neither, the collage is
    square. Returns the path written, or the uint8 collage array without
    ``save``.
    """
    from ..utils import png

    images = np.asarray(images)
    if images.ndim == 3:
        images = images[..., None]
    count = images.shape[0]
    if w:
        h = count // w
    elif h:
        w = count // h
    else:
        h = w = int(np.sqrt(count))
    strips = [
        np.concatenate(list(images[row : row + w]), axis=1)
        for row in range(0, h * w, w)
    ]
    collage = np.clip(np.concatenate(strips, axis=0) * 255.0, 0, 255)
    collage = collage.astype(np.uint8)
    if save:
        if collage.shape[2] == 1:
            png.write_png(save, collage[..., 0])
        elif collage.shape[2] == 3:
            png.write_png(save, collage[..., ::-1])  # BGR -> RGB
        else:
            raise ValueError(f"view_batch saves 1 or 3 channels, got "
                             f"{collage.shape[2]}")
        return Path(save)
    return collage


def plot_stats(train_accs, train_losses, val_accs, val_losses, title=None,
               outfile=None, first_epoch=1, epoch_step=1):
    """Per-epoch accuracy/loss curves (reference ``plot.py:75-124``):
    two stacked panels sharing the epoch axis."""
    plt = _plt()
    _style(plt, "dark_background")
    fig, axes = plt.subplots(2, 1, sharex=True, dpi=100, figsize=(12, 8.4))
    n_epochs = len(train_accs)
    plt.xticks(np.arange(0, n_epochs, epoch_step),
               np.arange(first_epoch, first_epoch + n_epochs, epoch_step))
    plt.xlabel("Epoch")
    if title:
        plt.title(title)
    panels = (
        (axes[0], "Accuracy", train_accs, val_accs),
        (axes[1], "Loss", train_losses, val_losses),
    )
    for ax, axis_label, train_series, val_series in panels:
        ax.plot(train_series, **_TRAIN_STYLE)
        ax.plot(val_series, **_VAL_STYLE)
        ax.legend(loc="upper left")
        ax.set_ylabel(axis_label)
    plt.tight_layout()
    if outfile:
        plt.savefig(outfile)
    plt.close()


def plot_img(img, title="", save=None):
    """Show/save a single image (reference ``plot.py:158-171``)."""
    plt = _plt()
    plt.axis("off")
    if title:
        plt.title(title)
    img = np.asarray(img)
    if img.ndim == 2 or img.shape[-1] == 1:
        plt.imshow(img.reshape(img.shape[0], img.shape[1]), cmap="gray")
    else:
        plt.imshow(img[..., ::-1])  # BGR -> RGB
    if save:
        plt.savefig(save, bbox_inches="tight")
    plt.close()


def dataset_distribution(data, save=None, size=(8.4, 12)):
    """Horizontal bar chart of class sizes (reference ``plot.py:127-155``),
    smallest class at the bottom, alphabetical among equals.

    ``data`` is a :class:`sykepic_tpu_torch.train.data.ModelData` (uses its
    ``distribution`` mapping).
    """
    plt = _plt()
    ordered = sorted(sorted(data.distribution.items()),
                     key=lambda kv: kv[1][0])
    labels = [name for name, _counts in ordered]
    totals = [counts[0] for _name, counts in ordered]

    _style(plt, "dark_background")
    plt.figure(figsize=size)
    plt.barh(labels, totals, color=_TRAIN_STYLE["c"])
    for pos, total in enumerate(totals):
        plt.text(total, pos, f" {total}", va="center", color=_VAL_STYLE["c"])
    plt.grid(False)
    ax = plt.gca()
    ax.get_xaxis().set_visible(False)
    for spine in ax.spines.values():
        spine.set_visible(False)
    if save:
        plt.tight_layout()
        plt.savefig(save, dpi=100)
    plt.close()
