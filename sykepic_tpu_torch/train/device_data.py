"""Device-resident training dataset: upload once, gather per step (the port
of ``sykepic_tpu/train/device_data.py``).

Plankton training sets are small next to a card's memory (tens to hundreds
of MB of uint8), so the dataset is treated like weights: decoded, bucketed
by canvas shape and uploaded ONCE, one uint8 store per bucket; each train
step then ships only a ``(batch,)`` index vector and K1 reads every image in
place, with the store row as its window index
(:func:`sykepic_tpu_torch.ops.resize_pad.resize_pad`) -- no gather of pixels.

Replaces nothing semantically: oversampled occurrence lists, per-image
resize geometry (``ops/preprocess.compute_geometry``), border fill
(reference ``image.py:20-37,229-237``) and translate limits (reference
``image.py:39-51``) are identical to the host path -- they are per-IMAGE
quantities, precomputed at load time and stored with the pixels.

TRAIN batches are stratified across buckets (:class:`MixedGatheredBatch`:
a fixed per-bucket composition drawn from every store, one K1 launch per
bucket into one batch). Bucket-PURE batches are near-class-pure when ROI
size correlates with class -- true of plankton data -- and per-batch
BatchNorm statistics then erase the very signal that separates the classes
(the JAX package measured a collapse to chance accuracy on a
size-correlated synthetic set, ``tests/test_device_data.py``). Eval batches
stay bucket-pure (no per-batch statistics). Membership and batch order
reshuffle every epoch.

Duplicate occurrences (oversampling, reference ``data.py:132-148``) share
one store row: pixels are decoded and uploaded once per unique file, and
the occurrence -> row map lives on the host. The index planning is the JAX
package's numpy code, so a seed gives the same plans row for row.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..ingest import pack
from ..ops import augment as augment_ops
from ..ops import preprocess
from . import input as input_mod


@dataclass
class GatheredBatch:
    """A batch addressed by store rows instead of shipped pixels.
    ``Trainer.train_batch``/``eval_batch`` dispatch on this type, so the
    epoch loop is agnostic to host-shipped vs device-resident data.
    ``labels`` is the host-side copy consumers like ``loop.test_net`` read
    per batch (the device store carries its own gathered copy)."""

    store: dict  # device-resident per-bucket tensors (device_store)
    idx: np.ndarray  # (B,) int32 store rows
    weights: np.ndarray  # (B,) float32, 0 for wrapped tail slots
    labels: np.ndarray  # (B,) int32 host labels (mirrors store gather)


@dataclass
class MixedGatheredBatch:
    """A stratified TRAIN batch drawing from every canvas bucket at once:
    parallel tuples of (store, index vector), one K1 launch per bucket
    into one batch (``Trainer.train_batch_mixed``). Exists because
    canvas-pure batches are near-class-pure on size-correlated data and
    per-batch BatchNorm statistics then erase the class signal (see
    :meth:`DeviceDataset.epoch_mixed`)."""

    stores: tuple  # one device-resident store per contributing bucket
    idxs: tuple  # parallel (c_i,) int32 row vectors
    weights: np.ndarray  # (sum c_i,) float32, 0 for wrapped pad slots
    labels: np.ndarray  # (sum c_i,) int32 host labels, bucket order

    def split_weights(self):
        """Per-bucket views of ``weights`` (parallel to ``idxs``)."""
        out, pos = [], 0
        for idx in self.idxs:
            out.append(self.weights[pos : pos + len(idx)])
            pos += len(idx)
        return out


def make_store(canvas, heights, widths, labels, spec) -> dict:
    """Metadata-complete (host) store dict from packed arrays: the JAX
    package's field set. :func:`device_store` puts it on the card in the
    form K1 reads."""
    new_h, new_w, pad_top, pad_left = preprocess.compute_geometry(
        heights, widths, spec.target_h, spec.target_w
    )
    border = preprocess.border_values(canvas, heights, widths, spec.border)
    lim_x, lim_y = augment_ops.translate_limits(
        heights, widths, new_h, new_w, spec.target_h, spec.target_w
    )
    return {
        "canvas": canvas,
        "heights": heights,
        "widths": widths,
        "new_h": new_h,
        "new_w": new_w,
        "pad_top": pad_top,
        "pad_left": pad_left,
        "border": border,
        "lim_x": lim_x,
        "lim_y": lim_y,
        "labels": np.asarray(labels, np.int32),
    }


def device_store(host: dict, device) -> dict:
    """A :func:`make_store` dict as device tensors in the form the train
    and eval steps read: ``canvas`` uint8 ``(n, h, w)``; ``meta`` int32
    ``(10, n)``, K1's slot metadata with the store row as window index and
    origin 0 (:data:`~sykepic_tpu_torch.ops.preprocess.META_ROWS`);
    ``lim`` int32 ``(2, n)`` translate limits (x, y); ``labels`` int64."""
    n = len(host["heights"])
    meta = preprocess.slot_meta(
        host["heights"], host["widths"], host["new_h"], host["new_w"],
        host["pad_top"], host["pad_left"], host["border"],
        win_idx=np.arange(n, dtype=np.int32))
    lim = np.stack([host["lim_x"], host["lim_y"]]).astype(np.int32)
    return {
        "canvas": torch.from_numpy(np.ascontiguousarray(host["canvas"]))
        .to(device),
        "meta": torch.from_numpy(meta).to(device),
        "lim": torch.from_numpy(lim).to(device),
        "labels": torch.from_numpy(
            np.asarray(host["labels"], np.int64)).to(device),
    }


def estimate_nbytes(paths, spec, buckets=pack.DEFAULT_BUCKETS) -> int:
    """Predicted device bytes for a :class:`DeviceDataset` over ``paths``
    WITHOUT decoding any pixels: PNG IHDR dims -> pre-shrink prediction ->
    bucket -> per-bucket power-of-two row rounding, exactly mirroring the
    constructor. Lets callers budget-check a large set cheaply before
    committing to the decode+upload. Non-PNG files are assumed
    target-sized.

    ``buckets`` follows the pack-wide convention (``None`` = dynamic snap
    grid) and defaults to :data:`pack.DEFAULT_BUCKETS` — the same default
    as the :class:`DeviceDataset` constructor, so the estimate budgets
    against the bucketing the dataset will actually use."""
    counts: dict[tuple[int, int], int] = {}
    seen: set = set()
    for p in paths:
        key = str(p)
        if key in seen:
            continue
        seen.add(key)
        dims = input_mod.png_dims(p)
        h, w = dims if dims else (spec.target_h, spec.target_w)
        h, w = pack.shrunk_dims(h, w, spec.target_h, spec.target_w)
        bucket = pack.bucket_for(h, w, buckets)
        counts[bucket] = counts.get(bucket, 0) + 1
    total = 0
    for (bh, bw), n in counts.items():
        n_pad = 1 << (n - 1).bit_length()
        # canvas + 9 int32 metadata/label arrays + uint8 border per row
        total += n_pad * (bh * bw + 37)
    return total


class DeviceDataset:
    """Decode + bucket + upload a labeled image list; iterate epochs as
    (store, idx, weights) batches for
    :meth:`~sykepic_tpu_torch.train.trainer.Trainer.train_batch_gathered`.

    Parameters mirror :class:`~sykepic_tpu_torch.train.input.BatchLoader`
    where they overlap. ``spec`` is the trainer's ``PreprocessSpec``
    (target dims + border mode drive the precomputed metadata; images are
    pre-shrunk to the target like the host loader's ``pre_shrink_to``).
    ``device`` holds the stores (the trainer's device).

    ``buckets`` defaults to the COARSE fixed list (not the host loaders'
    fine snap grid), as in the JAX package; it bounds the number of stores,
    and so of K1 launches a mixed step makes.

    ``nbytes`` counts the JAX package's store fields (canvas, 9 int32
    metadata arrays and a uint8 border a row), which
    :func:`estimate_nbytes` predicts exactly; the card holds the same
    metadata as K1's ``(10, n)`` int32 slot rows plus ``(2, n)`` limits and
    int64 labels, 68 bytes a row against the counted 37.
    """

    def __init__(
        self,
        paths,
        labels,
        spec,
        batch_size: int = 256,
        seed: int = 0,
        num_threads: int = 8,
        buckets=pack.DEFAULT_BUCKETS,
        device="cpu",
        batch_multiple: int = 1,
        shuffle: bool = False,
    ):
        self.paths = list(paths)
        self.batch_size = batch_size
        self.batch_multiple = batch_multiple
        self.shuffle = shuffle  # default for the __iter__ protocol
        self.rng = np.random.default_rng(seed)
        # one store row per unique file; occurrences map onto rows. A file
        # listed under TWO different labels cannot share a row (the store
        # keeps one label per row; last-write-wins would silently relabel
        # every occurrence) — fail loudly, the host BatchLoader honors
        # per-occurrence labels and is the escape hatch.
        unique: dict = {}
        row_label_of: dict = {}
        self.occ_rows = np.empty(len(self.paths), np.int64)
        occ_labels = np.zeros(len(self.paths), np.int32)
        for i, p in enumerate(self.paths):
            key = str(p)
            label = 0 if labels is None else int(labels[i])
            if key not in unique:
                unique[key] = len(unique)
                row_label_of[key] = label
            elif row_label_of[key] != label:
                raise ValueError(
                    f"{p} appears with conflicting labels "
                    f"({row_label_of[key]} and {label}); a device-resident "
                    "store keeps one label per unique file — use the host "
                    "loader (device_cache = no) for per-occurrence labels"
                )
            self.occ_rows[i] = unique[key]
            occ_labels[i] = label

        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            imgs = list(pool.map(
                lambda p: pack.pre_shrink(
                    input_mod.read_image(p), spec.target_h, spec.target_w
                ),
                unique.keys(),
            ))

        # bucket rows by canvas shape; remap occurrence rows to
        # (bucket, local row)
        by_bucket: dict[tuple[int, int], list[int]] = {}
        for row, img in enumerate(imgs):
            bh, bw = pack.bucket_for(img.shape[0], img.shape[1], buckets)
            by_bucket.setdefault((bh, bw), []).append(row)

        row_label = np.zeros(len(imgs), np.int32)
        row_label[self.occ_rows] = occ_labels  # same file => same label
        self.stores: dict[tuple[int, int], dict] = {}
        self._host_labels: dict[tuple[int, int], np.ndarray] = {}
        self._bucket_of_row = np.empty(len(imgs), np.int64)
        self._local_of_row = np.empty(len(imgs), np.int64)
        self.num_rows = len(imgs)  # unique decoded files (pre-padding)
        self.nbytes = 0
        for bi, ((bh, bw), rows) in enumerate(sorted(by_bucket.items())):
            # round the store's row count up to a power of two (zeros are
            # never indexed), as the JAX package does, so nbytes and the
            # estimate match it
            n = 1 << (len(rows) - 1).bit_length()
            canvas = np.zeros((n, bh, bw), np.uint8)
            heights = np.ones(n, np.int32)
            widths = np.ones(n, np.int32)
            for j, row in enumerate(rows):
                img = imgs[row]
                if img.shape[0] > bh or img.shape[1] > bw:
                    img = pack.shrink_to_fit(img, bh, bw)
                h, w = img.shape
                canvas[j, :h, :w] = img
                heights[j] = h
                widths[j] = w
                self._bucket_of_row[row] = bi
                self._local_of_row[row] = j
            store_labels = np.zeros(n, np.int32)
            store_labels[: len(rows)] = row_label[rows]
            self._host_labels[(bh, bw)] = store_labels
            store = make_store(canvas, heights, widths, store_labels, spec)
            self.nbytes += sum(a.nbytes for a in store.values())
            self.stores[(bh, bw)] = device_store(store, device)
        self._bucket_keys = sorted(by_bucket.keys())

    @property
    def num_samples(self) -> int:
        return len(self.paths)

    def _pieces(self, n: int, b: int):
        """Ladder piece sizes covering ``n`` occurrences; the single
        source of truth for :meth:`epoch` and :meth:`__len__`. Yields
        ``(piece, real)`` with ``real < piece`` only for the final
        wrapped-pad piece.

        Tail pieces come from the ``batch_multiple * 2**k`` ladder (full
        batches are ``b`` itself): every emitted size must stay divisible
        by the data mesh axis, and simply halving ``b`` breaks that for
        non-power-of-two meshes (e.g. b=258, multiple=3 halves to 129).
        The smallest ladder piece is ~b/4, so wrap-pad waste is bounded
        by a quarter batch per bucket."""
        m = max(self.batch_multiple, 1)
        min_piece = m
        while min_piece * 2 <= max(b // 4, m):
            min_piece *= 2
        remaining = n
        while remaining > 0:
            if remaining >= b:
                yield b, b
                remaining -= b
                continue
            piece = min_piece
            while piece * 2 <= remaining and piece * 2 <= b:
                piece *= 2
            real = min(piece, remaining)
            yield piece, real
            remaining -= real

    def __len__(self) -> int:
        """Batches per epoch (of the ``__iter__`` protocol's mode)."""
        if self._use_mixed:
            return self._mixed_len()
        total = 0
        for bi, key in enumerate(self._bucket_keys):
            occ = int(np.sum(self._bucket_of_row[self.occ_rows] == bi))
            if occ == 0:
                continue
            b = pack.effective_batch_size(self.batch_size, key,
                                          multiple=self.batch_multiple)
            total += sum(1 for _ in self._pieces(occ, b))
        return total

    def epoch(self, shuffle: bool = True):
        """Yield ``(bucket_key, idx, weights)`` batches covering every
        occurrence exactly once.

        Tail handling: each bucket's leftover rides a short pow2 ladder
        (b, b/2, b/4) instead of padding straight to the full batch —
        weight-0 wrap slots are COMPUTED (their pixels run the whole
        fwd+bwd). Only the final sub-quarter piece still wraps with
        weight-0 duplicates (BatchNorm never sees zero frames, the loss
        mask excludes them — same policy as the host loader).
        """
        batches = []
        occ_buckets = self._bucket_of_row[self.occ_rows]
        for bi, key in enumerate(self._bucket_keys):
            occ = np.nonzero(occ_buckets == bi)[0]
            if len(occ) == 0:
                continue
            local = self._local_of_row[self.occ_rows[occ]]
            if shuffle:
                self.rng.shuffle(local)
            b = pack.effective_batch_size(self.batch_size, key,
                                          multiple=self.batch_multiple)
            pos = 0
            for piece, real in self._pieces(len(local), b):
                idx = local[pos : pos + real]
                pos += real
                weights = np.zeros(piece, np.float32)
                weights[:real] = 1.0
                while len(idx) < piece:  # wrap with weight-0 duplicates
                    idx = np.concatenate([idx, local[: piece - len(idx)]])
                batches.append((key, idx.astype(np.int32), weights))
        if shuffle:
            self.rng.shuffle(batches)
        yield from batches

    def epoch_mixed(self, shuffle: bool = True):
        """Yield stratified mixed batches: every batch draws a FIXED
        per-bucket composition ``c_i = ceil(occ_i / n_batches)``, covering
        each occurrence exactly once (final slots wrap with weight-0
        duplicates, same policy as :meth:`epoch`).

        Why: a canvas-pure batch is near-class-pure whenever ROI size
        correlates with class — true of real plankton data — and training
        BatchNorm then normalizes per batch exactly the statistics that
        separate the classes. On a synthetic set with perfect size/class
        correlation, bucket-pure batches collapse training to chance
        accuracy while mixed batches (and the host loader) learn it —
        ``tests/test_device_data.py::
        test_bucket_pure_batches_learn_size_correlated_classes``.
        The fixed composition keeps every batch the same size (the pow2
        tail ladder of :meth:`epoch` isn't needed: there are no tail
        batches).

        Yields ``(bucket_keys, idx_tuple, weights)`` with ``weights`` the
        concatenation over buckets in ``bucket_keys`` order.
        """
        slots, n_batches = self._mixed_slots(shuffle=shuffle)
        if not slots:
            return
        for j in range(n_batches):
            keys = tuple(key for key, _, _, _ in slots)
            idxs = tuple(p[j * c : (j + 1) * c] for _, c, p, _ in slots)
            weights = np.concatenate(
                [w[j * c : (j + 1) * c] for _, c, _, w in slots]
            )
            yield keys, idxs, weights

    def _mixed_slots(self, shuffle: bool = True):
        """Per-bucket slot plan for one stratified epoch: a list of
        ``(bucket_key, c, padded_rows, weights)`` with ``padded_rows`` /
        ``weights`` flat ``(n_batches * c,)`` arrays (batch ``j`` owns
        slice ``[j*c:(j+1)*c]``), plus ``n_batches``. The single source of
        truth behind both the streaming :meth:`epoch_mixed` and the
        whole-epoch :meth:`epoch_mixed_stacked`."""
        occ_buckets = self._bucket_of_row[self.occ_rows]
        per_bucket = []
        for bi, key in enumerate(self._bucket_keys):
            occ = np.nonzero(occ_buckets == bi)[0]
            if len(occ):
                rows = self._local_of_row[self.occ_rows[occ]].copy()
                per_bucket.append((key, rows))
        total = sum(len(rows) for _, rows in per_bucket)
        if total == 0:
            return [], 0
        n_batches = max(-(-total // self.batch_size), 1)
        slots = []
        for key, rows in per_bucket:
            if shuffle:
                self.rng.shuffle(rows)
            c = -(-len(rows) // n_batches)  # ceil: every row gets a slot
            need = n_batches * c
            weights = np.zeros(need, np.float32)
            weights[: len(rows)] = 1.0
            padded = rows
            while len(padded) < need:  # wrap with weight-0 duplicates
                padded = np.concatenate([padded, rows[: need - len(padded)]])
            slots.append((key, c, padded.astype(np.int32), weights))
        return slots, n_batches

    def epoch_mixed_stacked(self, shuffle: bool = True):
        """The whole stratified epoch as stacked arrays, for the
        whole-epoch call (``Trainer.train_epoch_mixed``):
        ``(stores, idxs_stacked, weights_stacked)`` with ``stores`` the
        per-bucket store tuple, ``idxs_stacked`` a parallel tuple of
        ``(n_batches, c_i)`` int32 matrices and ``weights_stacked`` the
        ``(n_batches, sum c_i)`` float32 weight matrix. Row ``j`` of every
        array is EXACTLY batch ``j`` of :meth:`epoch_mixed` (same slot
        plan), so the whole-epoch call covers each occurrence once with the
        identical composition. Returns ``None`` when the set is empty."""
        slots, n_batches = self._mixed_slots(shuffle=shuffle)
        if not slots:
            return None
        stores = tuple(self.stores[key] for key, _, _, _ in slots)
        idxs = tuple(p.reshape(n_batches, c) for _, c, p, _ in slots)
        weights = np.concatenate(
            [w.reshape(n_batches, c) for _, c, _, w in slots], axis=1
        )
        return stores, idxs, weights

    def _mixed_len(self) -> int:
        """Batches per epoch in mixed mode."""
        occ = len(self.occ_rows)
        return max(-(-occ // self.batch_size), 1) if occ else 0

    @property
    def _use_mixed(self) -> bool:
        # Mixing only matters with >1 bucket; a single bucket already
        # yields globally shuffled batches through the pure path.
        return self.shuffle and len(self._bucket_keys) > 1

    def __iter__(self):
        """Epoch of batches — drop-in for the host ``BatchLoader``
        iteration protocol in the train/val/test loops. Shuffled (train)
        iteration emits stratified :class:`MixedGatheredBatch` es;
        sequential (val/test) iteration keeps bucket-pure
        :class:`GatheredBatch` es (eval has no per-batch statistics)."""
        if self._use_mixed:
            for keys, idxs, weights in self.epoch_mixed(shuffle=True):
                labels = np.concatenate([
                    self._host_labels[k][i] for k, i in zip(keys, idxs)
                ])
                yield MixedGatheredBatch(
                    tuple(self.stores[k] for k in keys), idxs, weights,
                    labels,
                )
            return
        for key, idx, weights in self.epoch(shuffle=self.shuffle):
            yield GatheredBatch(self.stores[key], idx, weights,
                                self._host_labels[key][idx])
