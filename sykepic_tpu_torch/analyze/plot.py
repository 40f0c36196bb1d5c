"""Training-curve plot (the port of ``sykepic_tpu/analyze/plot.py::
plot_stats``; reference ``sykepic/analyze/plot.py:75-124``).

Matplotlib is optional (a GPU host may lack it). :func:`available`
says whether it imports; the train loop then skips the plots and says so
once in its log. It is imported lazily with the Agg backend, so headless
training nodes never need a display.
"""

from __future__ import annotations

import numpy as np

# series styling (the reference's look; appearance is not a parity contract)
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


def plot_stats(train_accs, train_losses, val_accs, val_losses, title=None,
               outfile=None, first_epoch=1, epoch_step=1):
    """Per-epoch accuracy/loss curves: two stacked panels sharing the
    epoch axis."""
    plt = _plt()
    plt.style.use("dark_background")
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
