"""Host-side training input pipeline (the port of
``sykepic_tpu/train/input.py``; replaces torch ``DataLoader`` use in
reference ``sykepic/train/data.py:150-231``).

Design: worker threads decode PNGs (the port's own reader,
:mod:`sykepic_tpu_torch.utils.png`: ``zlib`` releases the GIL while it
inflates), each shuffled
batch is packed into ONE fixed-canvas uint8 array sized to the smallest
bucket that fits every image in the batch (bounded set of canvas shapes =>
bounded XLA recompiles), and a background thread keeps ``prefetch`` batches
ready so the device never waits on the host. All pixel work (resize, pad,
augment, normalize) happens on device.

The tail batch is padded to the fixed batch size by *repeating real images*
(weight 0) rather than zeros, so BatchNorm batch statistics are not polluted
by black frames; the loss/accuracy mask excludes the duplicates.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..ingest import pack
from ..utils import png

png_dims = png.png_dims


@dataclass
class HostBatch:
    """One decoded, packed batch ready for device preprocessing."""

    canvas: np.ndarray  # (B, Hc, Wc) uint8
    heights: np.ndarray  # (B,) int32
    widths: np.ndarray  # (B,) int32
    labels: np.ndarray  # (B,) int32
    weights: np.ndarray  # (B,) float32 -- 0 for padded duplicate slots
    paths: list  # per-slot source path (for inference mode)


def read_image(path) -> np.ndarray:
    """Decode one PNG to 2-D uint8 grayscale, as the JAX package's
    ``cv2.imread(path, IMREAD_GRAYSCALE)`` does.

    The reference reads 3-channel BGR and converts to RGB
    (``data.py:218-223``); IFCB PNGs are grayscale triplicated across
    channels, so a single-channel read is lossless and 3x cheaper. Channel
    replication happens on the device in the resize/pad kernel.
    """
    return png.read_png(path)


class BatchLoader:
    """Iterable over packed host batches of a labeled image list.

    Parameters
    ----------
    paths, labels : aligned lists (labels may be None for inference lists)
    batch_size : fixed device batch size
    shuffle : reshuffle each epoch (fresh numpy RNG stream seeded once,
        mirroring torch DataLoader(shuffle=True) behavior)
    num_threads : PNG-decode worker threads
    prefetch : batches decoded ahead of the consumer
    pre_shrink_to : (target_h, target_w) or None
        Host-downscale images LARGER than the model target before packing
        (the device resize would downsample them anyway; shipping the
        downsampled pixels cuts host->device bytes — same rationale and
        fixed-point resize dims as the inference engine's pre-shrink,
        ``ingest/pack.py::pre_shrink``).
    size_pool : int
        With ``shuffle``, images are grouped into pools of
        ``batch_size * size_pool``, sorted by decoded size inside each
        pool, and the resulting batches are shuffled in order. Each
        batch's canvas is sized to its largest member, so size-homogeneous
        batches ship far fewer padding bytes (a single large image
        otherwise inflates all 256 slots). 1 disables pooling.
    """

    def __init__(
        self,
        paths,
        labels=None,
        batch_size: int = 256,
        shuffle: bool = False,
        seed: int = 0,
        num_threads: int = 8,
        prefetch: int = 2,
        buckets=pack.DEFAULT_BUCKETS,
        cache_bytes: int = 2 * 1024**3,
        pre_shrink_to=None,
        size_pool: int = 16,
    ):
        self.paths = list(paths)
        self.labels = None if labels is None else np.asarray(labels, np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.buckets = buckets
        self.pre_shrink_to = (
            None if pre_shrink_to is None else tuple(pre_shrink_to)
        )
        self.size_pool = size_pool
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        # Decoded-image cache: plankton training sets are tiny (~3 KB/ROI,
        # tens of MB total), so epochs 2+ skip PNG decoding entirely. The
        # cache stops growing at cache_bytes (0 disables it).
        self._cache: dict[int, np.ndarray] = {}
        self._cache_budget = cache_bytes
        self._sizes = None  # lazy: packed-size sort keys for pooling

    def __len__(self) -> int:
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        return len(self.paths)

    def _make_batch(self, idx: np.ndarray) -> HostBatch:
        n = len(idx)
        b = self.batch_size
        # Pad the tail by repeating real slots (weight 0)
        full = np.concatenate([idx, idx[: b - n]]) if n < b else idx
        while len(full) < b:  # tiny datasets: repeat until full
            full = np.concatenate([full, full[: b - len(full)]])
        paths = [self.paths[i] for i in full]
        imgs = [self._cache.get(int(i)) for i in full]
        missing = [k for k, img in enumerate(imgs) if img is None]
        if missing:
            decoded = list(
                self._pool.map(self._decode_one, [full[k] for k in missing])
            )
            for k, img in zip(missing, decoded):
                imgs[k] = img
        max_h = max(img.shape[0] for img in imgs)
        max_w = max(img.shape[1] for img in imgs)
        bh, bw = pack.bucket_for(max_h, max_w, self.buckets)
        canvas = np.zeros((b, bh, bw), np.uint8)
        heights = np.ones(b, np.int32)
        widths = np.ones(b, np.int32)
        for i, img in enumerate(imgs):
            if img.shape[0] > bh or img.shape[1] > bw:
                img = pack.shrink_to_fit(img, bh, bw)
            h, w = img.shape
            canvas[i, :h, :w] = img
            heights[i] = h
            widths[i] = w
        labels = (
            self.labels[full]
            if self.labels is not None
            else np.zeros(b, np.int32)
        )
        weights = np.zeros(b, np.float32)
        weights[:n] = 1.0
        return HostBatch(canvas, heights, widths, labels, weights, paths)

    def _decode_one(self, idx_row) -> np.ndarray:
        """Decode (and optionally pre-shrink) one image, filling the cache."""
        img = read_image(self.paths[int(idx_row)])
        if self.pre_shrink_to is not None:
            img = pack.pre_shrink(img, *self.pre_shrink_to)
        if self._cache_budget > 0:
            self._cache[int(idx_row)] = img
            self._cache_budget -= img.nbytes
        return img

    def _size_keys(self) -> np.ndarray:
        """Per-image packed-size sort keys for pooled batching: PNG
        dimensions from the IHDR header (no pixel decode), post-pre-shrink,
        encoded as padded area. Non-PNG files sort last (unknown)."""
        keys = np.zeros(len(self.paths), np.int64)
        for i, p in enumerate(self.paths):
            dims = png_dims(p)
            if dims is None:
                keys[i] = np.iinfo(np.int64).max  # unknown: group at end
                continue
            h, w = dims
            if self.pre_shrink_to is not None:
                h, w = pack.shrunk_dims(h, w, *self.pre_shrink_to)
            keys[i] = (int(h) << 20) | int(w)
        return keys

    def _index_batches(self):
        order = np.arange(len(self.paths))
        b = self.batch_size
        if not self.shuffle:
            for start in range(0, len(order), b):
                yield order[start : start + b]
            return
        self.rng.shuffle(order)
        if self.size_pool > 1 and len(order) > b:
            if self._sizes is None:
                self._sizes = self._size_keys()
            if self.labels is not None:
                # CLASS-STRATIFIED size batching. Plain size-sorted pools
                # make batches near-class-pure whenever ROI size correlates
                # with class (it does in plankton data), and per-batch
                # BatchNorm statistics then normalize away the class signal
                # (measured as a training collapse on a size-correlated
                # synthetic set — tests/test_device_data.py). Instead: sort
                # each CLASS by size and deal per-class quantile chunks
                # into each batch, so every batch carries the global class
                # mix while staying size-tight within each class (canvas =
                # max over the batch; only the smaller classes' slots pay
                # padding). size_pool = 1 (INI `[image] size_pool`) is the
                # reference-faithful global shuffle.
                n_batches = -(-len(order) // b)
                dealt = [[] for _ in range(n_batches)]
                for lab in np.unique(self.labels):
                    grp = order[self.labels[order] == lab]
                    grp = grp[np.argsort(self._sizes[grp], kind="stable")]
                    # local window shuffle: vary batch membership across
                    # epochs without giving up the size ordering (a window
                    # of 2 chunks bounds how far an image drifts in size
                    # rank, so one large image cannot widen many batches)
                    w = max(2 * (len(grp) // n_batches), 4)
                    for s in range(0, len(grp), w):
                        self.rng.shuffle(grp[s : s + w])
                    # rotate so per-class +1 remainders spread over batches
                    rot = int(self.rng.integers(n_batches))
                    for j, chunk in enumerate(np.array_split(grp, n_batches)):
                        dealt[(j + rot) % n_batches].append(chunk)
                # per-class ceil/floor chunks leave batches a few slots off
                # b; rebalance by spilling overflow into the shortest
                # batches (NEVER by re-slicing a flattened order — boundary
                # drift was measured concentrating one class into a single
                # batch, exactly the composition this scheme exists to
                # avoid). Under-full batches pad in _make_batch.
                # shuffle within each batch BEFORE truncating overflow:
                # merged arrays are ordered class-by-class, so a plain
                # arr[b:] would always spill the last class's images and
                # skew overflowing batches against it
                merged = [self.rng.permutation(np.concatenate(chunks))
                          for chunks in dealt if chunks]
                spill: list = []
                for j, arr in enumerate(merged):
                    if len(arr) > b:
                        spill.extend(arr[b:].tolist())
                        merged[j] = arr[:b]
                for j in np.argsort([len(a) for a in merged]):
                    if not spill:
                        break
                    need = b - len(merged[j])
                    if need > 0:
                        take, spill = spill[:need], spill[need:]
                        merged[j] = np.concatenate(
                            [merged[j], np.asarray(take, merged[j].dtype)]
                        )
                batches = [a for a in merged if len(a)]
                self.rng.shuffle(batches)
                yield from batches
                return
            # Unlabeled streams (no class skew to worry about): sort inside
            # pools of batch_size * size_pool so a lone large image no
            # longer sizes all slots' canvas (measured ~4x padding bytes on
            # mixed datasets).
            pool = b * self.size_pool
            pieces = []
            for start in range(0, len(order), pool):
                chunk = order[start : start + pool]
                pieces.append(chunk[np.argsort(self._sizes[chunk],
                                               kind="stable")])
            order = np.concatenate(pieces)
            batches = [order[s : s + b] for s in range(0, len(order), b)]
            self.rng.shuffle(batches)
            yield from batches
            return
        for start in range(0, len(order), b):
            yield order[start : start + b]

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()
        errors: list[BaseException] = []

        def offer(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx in self._index_batches():
                    if cancel.is_set():
                        break
                    if not offer(self._make_batch(idx)):
                        break
            except BaseException as e:  # surfaced to the consumer below
                errors.append(e)
            finally:
                offer(stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # abandoning the iterator (exception in the consumer) must not
            # leave the producer blocked on a full queue forever
            cancel.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10)
        if errors:
            raise RuntimeError(
                f"BatchLoader producer failed: {errors[0]!r}"
            ) from errors[0]
