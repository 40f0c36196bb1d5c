"""Labeled-dataset handling for training (reference ``sykepic/train/data.py``).

Split/oversample semantics are kept *bit-identical* to the reference so a
given dataset + seed yields the same train/val/test membership. That goal
constrains the ALGORITHM — specifically the exact sequence of calls into
Python's global ``random`` module, because ``random.seed(s)`` +
``random.shuffle(seq)`` is a pure function of (seed, len(seq)) and the
reference re-seeds before every shuffle. The sequence-constrained calls are:

1. per class directory (in ``Path.iterdir()`` order): one seeded shuffle of
   the sorted file list (reference ``data.py:58-59``), and — only in the
   3-way-split case — one seeded shuffle of the accumulated test list
   *inside* the class loop (``data.py:88-89``);
2. after the loop: one seeded shuffle of the train list, then one of the
   val list (``data.py:92-95``);
3. ``list_files``: one seeded shuffle of a directory's filename list before
   truncating to ``max_N`` (``data.py:259-261``);
4. split boundaries must be ``int(round(n * fraction))`` (banker's
   rounding via Python ``round``, ``data.py:60-61``);
5. oversampling reuses items round-robin from index 0 (``data.py:309-316``)
   and the per-class groups are visited in ascending encoded-label order
   (``data.py:135-138``);
6. ``combined_shuffle`` is one seeded shuffle of an n-element sequence
   (``data.py:320-326``) — the permutation depends only on (seed, n), so
   shuffling an index vector reproduces it exactly.

Everything else here — decomposition, names, the artifact writer — is this
module's own.

A copy of ``sykepic_tpu/train/data.py`` (pure Python ``random`` and numpy),
so a dataset and seed give the JAX package's split and order exactly.

There is no torch ``DataLoader``. Batching is the job of
:mod:`sykepic_tpu_torch.train.input`, which packs decoded images into device
canvases; this module only owns file lists, labels, splits and the
``class_distribution.csv`` / ``class_names.txt`` artifacts.
"""

from __future__ import annotations

import os
import random
from pathlib import Path

import numpy as np


class LabelEncoder:
    """Minimal stand-in for ``sklearn.preprocessing.LabelEncoder``:
    ``classes_`` is the sorted unique label set."""

    def fit(self, labels):
        self.classes_ = np.unique(np.asarray(labels, dtype=object))
        self._index = {c: i for i, c in enumerate(self.classes_)}
        return self

    def transform(self, labels):
        try:
            return np.asarray([self._index[label] for label in labels])
        except KeyError as e:
            raise ValueError(f"y contains previously unseen labels: {e}") from e

    def fit_transform(self, labels):
        return self.fit(labels).transform(labels)

    def inverse_transform(self, indices):
        return self.classes_[np.asarray(indices)]


def _reseeded_shuffle(items: list, seed) -> None:
    """In-place ``random.seed(seed)`` + ``random.shuffle(items)`` — the
    reference's idiom for every deterministic shuffle (see module
    docstring, constraint set)."""
    random.seed(seed)
    random.shuffle(items)


class ModelData:
    """Dataset splitting, labeling and oversampling
    (reference ``data.py:17-192``)."""

    def __init__(self, dataset, split, min_N, max_N, exclude=(), random_seed=24):
        self.dataset = Path(dataset)
        self.split = split
        self.min_N = min_N
        self.max_N = max_N
        self.exclude = list(exclude)
        self.random_seed = random_seed
        self.oversampled = False
        self._build_splits()
        self._encode_labels()

    # -- splitting -------------------------------------------------------

    def _class_files(self, class_dir: Path) -> list[Path]:
        """Sorted candidate files of one class, pre-shuffled with the
        model seed (sequence constraint #1)."""
        found = sorted(
            list_files(class_dir, ".png", self.min_N, self.max_N,
                       self.exclude, self.random_seed)
        )
        _reseeded_shuffle(found, self.random_seed)
        return found

    def _build_splits(self):
        """Partition every class directory into train/val(/test) path
        lists (reference ``:31-95``; boundaries per constraint #4)."""
        fractions = tuple(self.split)
        with_test = len(fractions) == 3
        self.train_x = []
        self.val_x = []
        self.test_x = [] if with_test else None
        self.distribution = {}

        for class_dir in self.dataset.iterdir():
            files = self._class_files(class_dir)
            if not files:
                continue
            n = len(files)
            cut_a = int(round(n * fractions[0]))
            cut_b = cut_a + int(round(n * fractions[1]))
            pieces = (
                (files[:cut_a], files[cut_a:cut_b], files[cut_b:])
                if with_test else (files[:cut_a], files[cut_a:])
            )
            if not all(pieces):
                raise AssertionError(
                    f"class '{class_dir.name}' is too small to fill every "
                    f"split ({n} files) — raise min_N or change the split "
                    f"fractions"
                )
            self.distribution[class_dir.name] = [n] + [len(p) for p in pieces]
            self.train_x += pieces[0]
            self.val_x += pieces[1]
            if with_test:
                self.test_x += pieces[2]
                # the reference re-shuffles the ACCUMULATED test list once
                # per class, inside the loop (constraint #1)
                _reseeded_shuffle(self.test_x, self.random_seed)
        _reseeded_shuffle(self.train_x, self.random_seed)
        _reseeded_shuffle(self.val_x, self.random_seed)

    # -- labels ----------------------------------------------------------

    def _encode_labels(self):
        """Integer labels from parent directory names (reference
        ``:97-108``): the encoder is fit on the train split only."""
        self.le = LabelEncoder()
        self.train_y = list(
            self.le.fit_transform([p.parent.name for p in self.train_x])
        )
        self.val_y = list(self.le.transform([p.parent.name for p in self.val_x]))
        if self.test_x:
            self.test_y = list(
                self.le.transform([p.parent.name for p in self.test_x])
            )

    # -- artifacts -------------------------------------------------------

    def save(self, out_dir) -> None:
        """Write ``class_distribution.csv`` + ``class_names.txt``
        (reference ``:110-130``; byte-compatible artifact)."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        columns = ["class", "total", "train", "validation"]
        if self.test_x:
            columns.append("test")
        if self.oversampled:
            columns.append("oversampled")
        # rows ordered by class size descending, alphabetical among ties
        # (two stable sorts, mirroring the artifact's reference layout)
        rows = sorted(sorted(self.distribution.items()),
                      key=lambda kv: kv[1][0], reverse=True)
        lines = [",".join(columns)]
        for name, counts in rows:
            lines.append(",".join([name] + [str(c) for c in counts]))
        (out_dir / "class_distribution.csv").write_text("\n".join(lines))
        (out_dir / "class_names.txt").write_text("\n".join(self.le.classes_))

    # -- oversampling ----------------------------------------------------

    def oversample(self, until, decay) -> None:
        """Grow small training classes by round-robin reuse (reference
        ``:132-148``; group order per constraint #5)."""
        per_label: dict[int, list[Path]] = {}
        for path, label in zip(self.train_x, self.train_y):
            per_label.setdefault(label, []).append(path)
        self.over_x = []
        self.over_y = []
        for label in sorted(per_label):  # ascending encoded label
            extra, extra_y = oversample(
                per_label[label], [label] * len(per_label[label]), until, decay
            )
            class_name = self.le.inverse_transform([label])[0]
            counts = self.distribution[class_name]
            counts.append(len(extra))
            counts[1] += len(extra)
            self.over_x += extra
            self.over_y += extra_y
        self.oversampled = True

    def train_set(self):
        """(paths, labels) for training, oversampling folded in and shuffled
        (reference ``set_data_loaders``, ``:157-165``)."""
        if not self.oversampled:
            return list(self.train_x), list(self.train_y)
        return combined_shuffle(
            self.train_x + self.over_x, self.train_y + self.over_y,
            self.random_seed,
        )

    @property
    def num_classes(self) -> int:
        return len(self.le.classes_)


def list_files(root_dir, extension, min_N=None, max_N=None, exclude=(), random_seed=24):
    """Yield files below ``root_dir`` with allowed extensions
    (reference ``data.py:234-275``: directories named in ``exclude`` and
    directories under ``min_N`` files are skipped whole; over-full
    directories are truncated to ``max_N`` AFTER a seeded shuffle of the
    walk's filename list — sequence constraint #3)."""
    wanted = set(extension) if isinstance(extension, list) else {extension}
    for dirpath, _subdirs, names in os.walk(root_dir):
        folder = Path(dirpath)
        if folder.name in exclude:
            continue
        if min_N and len(names) < min_N:
            continue
        if max_N and len(names) > max_N:
            _reseeded_shuffle(names, random_seed)
            del names[max_N:]
        for name in names:
            candidate = folder / name
            if candidate.suffix in wanted:
                yield candidate.resolve()


def auto_id(name, directory) -> int:
    """Next free ``<name>_<N>`` version number (reference ``data.py:278-294``)."""
    used = [0]
    directory = Path(directory)
    if directory.is_dir():
        for path in directory.glob(f"{name}_*"):
            tail = path.name.rsplit("_", 1)[-1]
            if path.is_dir() and tail.isdigit():
                used.append(int(tail))
    return max(used) + 1


def oversample(x, y, until=None, decay=None):
    """Round-robin reuse until a size target (reference ``data.py:297-317``).

    The reference's argument guard is inverted (``data.py:303-306`` raises
    exactly when decay *is* provided, so its ``oversample_with_decay`` config
    path cannot run); this implements the documented intent: ``until`` wins,
    else the decay target ``int((1 + decay**len(x)) * len(x))``.
    """
    if not until:
        if not decay:
            raise ValueError("Must provide either 'until' or 'decay'")
        until = int((1 + decay ** len(x)) * len(x))
    shortfall = max(until - len(x), 0)
    picks = [i % len(x) for i in range(shortfall)]  # constraint #5
    return [x[i] for i in picks], [y[i] for i in picks]


def combined_shuffle(list1, list2, random_seed=24):
    """Shuffle two equal-length lists in lockstep (reference
    ``data.py:320-326``). One seeded shuffle of an index vector yields the
    identical permutation (constraint #6)."""
    order = list(range(len(list1)))
    _reseeded_shuffle(order, random_seed)
    return [list1[i] for i in order], [list2[i] for i in order]


def external_eval_set(data_dir, model_data, exclude=("Unclassified",),
                      random_seed=24):
    """(paths, labels) for an external test set
    (reference ``extra_eval_dataloader``, ``data.py:329-344``)."""
    files = sorted(list_files(data_dir, ".png", exclude=list(exclude)))
    _reseeded_shuffle(files, random_seed)
    labels = list(model_data.le.transform([p.parent.name for p in files]))
    return files, labels
