"""The inference engine: model dir -> packed ROI batches -> probabilities.

The port of ``sykepic_tpu/compute/engine.py``. One dispatch is

    uint8 windows or canvases --H2D (raw, or the wire codec decoded on the
    device)--> resize/pad kernel (K1) --> ResNet on cuDNN --> temperature
    softmax --> fixed-point uint16 rows --D2H--> per-ROI probability rows

The temperature hack is the reference's: logits are multiplied by
``ln(1.3)`` before the softmax (``SOFTMAX_EXP``, reference
``probability.py:18,191-194``).

Classification packs ROIs onto shelf windows; the fused pass below packs
per-ROI slot canvases. Both hand the kernel the same ``(10, R)`` int32 slot
metadata (:data:`sykepic_tpu_torch.ops.preprocess.META_ROWS`); the kernel
reads each ROI straight out of the uploaded pixels at its origin.

The fused pass (:meth:`Classifier.classify_and_feature_rois`, the
``pipeline --device-features`` path) packs slots without pre-shrink and runs
the same dispatch plus the geometry feature program
(:mod:`sykepic_tpu_torch.ops.features_device`, whose floods are K2) on the
one device copy of each canvas.

Results always come back as the fixed-point rows, the canvas grid is the
packer's dynamic one, and the in-flight depths are the constants of
:mod:`sykepic_tpu_torch.utils.depths`. The classify path's one switch is
``SYKEPIC_WIRE_CODEC`` (on unless set to ``off``).

The eval model runs in the memory format its network picks
(:meth:`sykepic_tpu_torch.models.resnet.Backbone.eval_memory_format`).

Under a mesh (``Classifier(mesh=...)``, one process per card; see
:mod:`sykepic_tpu_torch.parallel`) rank 0 decodes, packs and drains as
above, and every dispatch is spread over the ranks, as the JAX package
shards it (``sykepic_tpu/compute/engine.py:776-782``):

- a header (the dispatch's kind and shapes) is broadcast first;
- shelf windows (or their wire payload, decoded on every rank) and the
  ``(10, R)`` slot metadata are broadcast, and data rank ``d`` takes slot
  columns ``[d R/n, (d + 1) R/n)``;
- the fused pass's slot canvases are scattered along the batch axis (so
  the wire codec serves them only without a mesh) with their metadata
  columns;
- every rank runs K1 and the network (and, in the fused pass, the feature
  program with K2) on its share; the result rows are gathered to rank 0.

The other ranks serve dispatches in :meth:`Classifier.follow` until rank 0
calls :meth:`Classifier.release`. ``R`` is a multiple of the data axis
(``batch_size`` must be, as in JAX; the packers pad to it), and the ranks
of one data row along a ``model`` axis hold the same share.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from .. import parallel
from ..ingest import pack, shelf, wirecodec
from ..models import checkpoint
from ..ops import features_device, preprocess, wiredecode
from ..train import config as train_config
from ..utils import logger, profiling
from ..utils.depths import FUSED_PIPELINE_DEPTH, PIPELINE_DEPTH

SOFTMAX_EXP = 1.3

log = logger.get_logger("engine")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# 17-bit all-ones: unreachable for finite rows (clipped to <= 131070), so
# it round-trips non-finite device values back to NaN on the host
_NONFINITE_SENTINEL = (1 << 17) - 1

# the kinds of a mesh dispatch's header (Classifier.follow)
_RELEASE, _SHELF, _SHELF_WIRE, _FUSED = range(4)
_HEADER = 6  # int64 words: the kind, then up to five sizes


def _env_on(name: str) -> bool:
    return os.environ.get(name, "on").lower() not in ("off", "0", "no")


def _pack_probs_u16(p: torch.Tensor) -> torch.Tensor:
    """(B, C) f32 probabilities -> (B, C + ceil(C/16)) fixed-point rows:
    columns [0, C) carry round(p*1e5) & 0xFFFF, the tail words pack the
    17th bit of each value, 16 classes per word (bit j of word w belongs
    to class w*16+j). Non-finite values map to the sentinel 131071, which
    the host turns back into NaN.

    The rows are int16 tensors holding the uint16 bit patterns (torch's
    uint16 lacks kernels on both devices): each word is brought into
    [-32768, 32767] before the cast, so the cast is exact everywhere, and
    the host views the bytes as uint16 (:func:`unpack_probs_u16`)."""
    n, c = p.shape
    finite = torch.isfinite(p)
    safe = torch.where(finite, p.clamp(0.0, 1.3107), 0.0)
    v = torch.round(safe * 1e5).to(torch.int32)  # half to even, as rint
    v = torch.where(finite, v, _NONFINITE_SENTINEL)
    nw = -(-c // 16)
    ovf = torch.nn.functional.pad(v >> 16, (0, nw * 16 - c))  # 0/1
    weights = 1 << torch.arange(16, dtype=torch.int32, device=p.device)
    bits = (ovf.reshape(n, nw, 16) * weights).sum(dim=-1, dtype=torch.int32)
    words = torch.cat([v & 0xFFFF, bits], dim=1)
    return (words - (words >= 32768).to(torch.int32) * 65536).to(torch.int16)


def unpack_probs_u16(rows: np.ndarray, num_classes: int) -> np.ndarray:
    """Host inverse of :func:`_pack_probs_u16`: (B, C + ceil(C/16)) uint16
    (or the int16 rows, viewed as uint16) -> (B, C) float32
    probabilities, round(p*1e5) / 1e5 to within one f32 ulp."""
    rows = rows.view(np.uint16)
    c = num_classes
    lo = rows[:, :c].astype(np.int32)
    words = rows[:, c:]
    ovf = (words[:, :, None] >> np.arange(16, dtype=np.uint16)) & 1
    # explicit target shape: reshape(n, -1) cannot infer a dim on an
    # empty (0, nw) slice, and zero-valid batches do drain
    ovf = ovf.reshape(len(rows), words.shape[1] * 16)[:, :c].astype(np.int32)
    v = lo + (ovf << 16)
    out = v.astype(np.float32) * np.float32(1e-5)
    if (v >= _NONFINITE_SENTINEL).any():  # device saw NaN/Inf: stay loud
        out[v >= _NONFINITE_SENTINEL] = np.nan
    return out


class Classifier:
    """A loaded model directory, ready to classify packed ROI batches.

    Parameters
    ----------
    model_dir : path
        Directory with ``config.ini``, ``class_names.txt`` and
        ``best_state.msgpack`` (or a reference ``best_state.pth``).
    batch_size : int
        The fused pass's slot batch size; it also raises the shelf slot
        bound of classification above its 1024 floor.
    dtype : str
        "float32" (TF32 off in cuDNN and cuBLAS, so convolutions keep full
        float32) or "bfloat16" (autocast; the kernel writes bf16 pixels).
    device : str or torch.device
        ``cuda`` (the default) or ``cpu``; ``cuda`` without a card raises.
    mesh : DeviceMesh, optional
        A mesh of :mod:`sykepic_tpu_torch.parallel` over ranks whose
        devices are like ``device`` (one process per card): dispatches
        spread over its ``data`` axis, and wide kernels shard over its
        ``model`` axis. Every rank builds the classifier; rank 0 feeds it
        and the others call :meth:`follow`.
    """

    def __init__(self, model_dir, batch_size: int = 256,
                 dtype: str = "float32", device=None, mesh=None):
        self.device = device_mod.resolve(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot "
                                 f"classify on {self.device}")
            n_data = parallel.data_axis_size(mesh)
            if batch_size % n_data != 0:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the data "
                    f"mesh axis ({n_data})")
        model_dir = Path(model_dir)
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.model_dir = model_dir
        self.classes = checkpoint.read_class_names(model_dir)
        self.config = train_config.read_config(model_dir / "config.ini")
        self.spec = train_config.get_preprocess_spec(self.config)
        self.batch_size = batch_size
        self.dtype = _DTYPES[dtype]
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # cuDNN convolutions default to TF32 (about three digits),
            # which would break the probability bound
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model, _ = train_config.get_network(self.config, len(self.classes))
        _, dropout = train_config.get_head_spec(self.config)
        model.load_state_dict(checkpoint.load_model_state(
            model_dir, dropout, network=model.network), strict=True)
        # weights go to the device once, in the format their kernels read
        self.memory_format = model.eval_memory_format(self.dtype)
        log.info(f"{model.network} runs in {dtype} as "
                 f"{str(self.memory_format).removeprefix('torch.')}")
        self.model = model.to(self.device,
                              memory_format=self.memory_format).eval()
        # counters each slot of a dispatch adds, from the network's own
        # account of its work at the input size (Swin's windows)
        self._slot_counts = model.dispatch_counts(self.spec.target_h,
                                                  self.spec.target_w)
        self._batch_multiple = parallel.data_axis_size(mesh)
        if parallel.has_model_axis(mesh):
            # tensor parallel: wide late-stage kernels shard over the model
            # axis, the rest stays whole on every rank
            parallel.shard_wide_kernels(self.model, mesh)
        # shelf dispatches size themselves by window bytes; batch_size
        # still bounds the slot count when raised above the 1024 floor,
        # and shelf.SLOT_CAP hard-bounds it
        self._shelf_slot_cap = min(shelf.SLOT_CAP, max(batch_size, 1024))
        # lossless wire codec (ingest/wirecodec.py): 4-bit delta planes and
        # exception streams, decoded on the device; payoff-gated per
        # dispatch, so incompressible content ships raw either way
        self.wire_codec = _env_on("SYKEPIC_WIRE_CODEC")
        # host spans and counters (profiling.StageTimer), on with
        # SYKEPIC_PROFILE; read at each call, so a caller may swap it
        self.timer = profiling.StageTimer()

    # -- device side -------------------------------------------------------

    def _put(self, a) -> torch.Tensor:
        """Host array -> tensor on the device. From pageable memory a
        non-blocking copy returns once the source is staged, so the caller
        may reuse the buffer and the host runs ahead of the device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def _pixels(self, batch, host) -> torch.Tensor:
        """The batch's uint8 pixel tensor on the device: the wire payload
        decoded there when the producer encoded one, else ``host`` as is."""
        if batch.wire is not None:
            return wiredecode.decode(batch.wire, self.device)
        return self._put(host)

    def _forward(self, pixels: torch.Tensor, meta: torch.Tensor):
        """Device tensors -> fixed-point probability rows: K1, the
        network, the temperature softmax."""
        spec = self.spec
        x = preprocess.eval_preprocess_meta(
            pixels, meta, target_h=spec.target_h, target_w=spec.target_w,
            # never ImageNet-normalized: the reference normalizes only its
            # TRAIN transform (parity with its checkpoints)
            num_chans=spec.num_chans, dtype=self.dtype)
        x = x.permute(0, 3, 1, 2)  # NHWC storage: a channels_last NCHW view
        if self.memory_format == torch.contiguous_format:
            # one copy a dispatch: a channels_last input alone would make
            # every convolution channels_last again
            x = x.contiguous()
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            logits = self.model(x)
        probs = torch.softmax(
            logits.float() * math.log(SOFTMAX_EXP), dim=-1)
        return _pack_probs_u16(probs)

    def _shelf_meta(self, batch) -> np.ndarray:
        """Slot metadata for one shelf batch as ONE (10, R) int32 array
        (one upload per dispatch). Padding slots are 1x1 zero ROIs and
        flow through harmlessly."""
        new_h, new_w, pad_top, pad_left = preprocess.compute_geometry(
            batch.heights, batch.widths, self.spec.target_h,
            self.spec.target_w)
        if self.spec.border == "mode":
            border = batch.modes
            if border is None:
                # a hand-built ShelfBatch may lack precomputed modes:
                # recover them from the windows
                border = np.zeros(len(batch.heights), np.uint8)
                for i in range(batch.n_valid):
                    w, y, x = (int(batch.win_idx[i]), int(batch.y0[i]),
                               int(batch.x0[i]))
                    roi = batch.windows[
                        w, y:y + int(batch.heights[i]),
                        x:x + int(batch.widths[i])]
                    border[i] = pack.mode_pixel(roi)
        elif self.spec.border == "white":
            border = np.full(len(batch.heights), 255, np.uint8)
        elif self.spec.border == "black":
            border = np.zeros(len(batch.heights), np.uint8)
        else:
            raise ValueError(f"Unknown border mode: {self.spec.border}")
        return preprocess.slot_meta(
            batch.heights, batch.widths, new_h, new_w, pad_top, pad_left,
            border, win_idx=batch.win_idx, y_origin=batch.y0,
            x_origin=batch.x0)

    def _host_meta(self, batch: pack.PackedBatch) -> np.ndarray:
        """Slot metadata for one packed batch: slot ``r`` reads canvas
        ``r`` at origin 0. Cheap when the packer pre-computed the modes;
        otherwise a histogram pass over the padded canvas."""
        new_h, new_w, pad_top, pad_left = preprocess.compute_geometry(
            batch.heights, batch.widths, self.spec.target_h,
            self.spec.target_w)
        if batch.modes is not None and self.spec.border == "mode":
            border = batch.modes
        else:
            border = preprocess.border_values(
                batch.canvas, batch.heights, batch.widths, self.spec.border)
        return preprocess.slot_meta(batch.heights, batch.widths, new_h,
                                    new_w, pad_top, pad_left, border)

    def dispatch_shelf(self, batch, meta=None) -> torch.Tensor:
        """Start inference for one shelf batch; returns the result on the
        device without waiting for it."""
        if meta is None:
            meta = self._shelf_meta(batch)
        with self.timer.stage("device.dispatch"), torch.inference_mode():
            if self.mesh is not None:
                return self._lead_shelf(batch, meta)
            return self._forward(self._pixels(batch, batch.windows),
                                 self._put(meta))

    # -- mesh ----------------------------------------------------------------

    @property
    def follower(self) -> bool:
        """Whether this process serves rank 0's dispatches (a mesh rank
        other than 0) rather than feeding its own."""
        return self.mesh is not None and parallel.rank() != 0

    def _header(self, kind: int = _RELEASE, *sizes) -> list:
        """Broadcast rank 0's header (``kind`` and sizes); returns it."""
        h = torch.zeros(_HEADER, dtype=torch.int64)
        h[:1 + len(sizes)] = torch.tensor([kind, *sizes])
        h = h.to(self.device)
        dist.broadcast(h, 0)
        return h.tolist()

    def _bcast(self, host, shape, dtype) -> torch.Tensor:
        """Rank 0's ``host`` array (others: the ``shape`` to receive) as a
        device tensor on every rank."""
        if host is not None:
            t = self._put(host)
        else:
            t = torch.empty(shape, dtype=dtype, device=self.device)
        dist.broadcast(t, 0)
        return t

    def _share(self, meta: torch.Tensor, rebase: bool):
        """This rank's slot columns of ``meta``: ``(lo, hi, columns)``;
        with ``rebase`` the window index counts from the share's first
        canvas (scattered slot canvases)."""
        lo, hi = parallel.shard_rows(meta.shape[1],
                                     parallel.data_axis_size(self.mesh),
                                     parallel.axis_index(self.mesh, "data"))
        cols = meta[:, lo:hi].clone()
        if rebase:
            cols[0] -= lo
        return lo, hi, cols

    def _gather(self, local: torch.Tensor):
        """Every rank's result rows to rank 0, in data order (one copy per
        data row: the first rank along a ``model`` axis); None elsewhere."""
        dtype = local.dtype
        # as bytes: neither NCCL nor gloo reduces or moves int16
        local = local.contiguous().view(torch.uint8)
        lead = parallel.rank() == 0
        parts = ([torch.empty_like(local) for _ in range(dist.get_world_size())]
                 if lead else None)
        dist.gather(local, parts, dst=0)
        if not lead:
            return None
        step = parallel.axis_size(self.mesh, "model")
        return torch.cat(parts[::step]).view(dtype)

    def _lead_shelf(self, batch, meta: np.ndarray) -> torch.Tensor:
        """Rank 0's half of a shelf dispatch under a mesh."""
        r = meta.shape[1]
        if batch.wire is not None:
            w = batch.wire
            self._header(_SHELF_WIRE, *w.plane.shape, len(w.exc), r)
            pixels = wiredecode.decode_tensors(
                *(self._bcast(a, None, None)
                  for a in (w.plane, w.exc, w.flags)))
        else:
            self._header(_SHELF, *batch.windows.shape, r)
            pixels = self._bcast(batch.windows, None, None)
        return self._serve_shelf(pixels, self._bcast(meta, None, None))

    def _serve_shelf(self, pixels, meta):
        _, _, cols = self._share(meta, rebase=False)
        return self._gather(self._forward(pixels, cols))

    def _lead_slots(self, canvas: np.ndarray, meta: np.ndarray):
        """Rank 0's half of a fused dispatch under a mesh."""
        self._header(_FUSED, *canvas.shape)
        return self._serve_slots(canvas.shape, canvas,
                                 self._bcast(meta, None, None))

    def _serve_slots(self, shape, canvas, meta):
        """Scatter the canvas rows, run both programs on this rank's
        share, gather."""
        lo, hi, cols = self._share(meta, rebase=True)
        mine = torch.empty((hi - lo, *shape[1:]), dtype=torch.uint8,
                           device=self.device)
        chunks = None
        if canvas is not None:
            n, step = (parallel.data_axis_size(self.mesh),
                       parallel.axis_size(self.mesh, "model"))
            rows = [parallel.shard_rows(shape[0], n, r // step)
                    for r in range(dist.get_world_size())]
            chunks = [self._put(canvas[a:b]) for a, b in rows]
        dist.scatter(mine, chunks, src=0)
        return (self._gather(self._forward(mine, cols)),
                self._gather(features_device.device_features(
                    mine, cols[3], cols[4])))

    def follow(self) -> None:
        """Serve rank 0's dispatches until it calls :meth:`release`: the
        loop of every mesh rank but 0."""
        if not self.follower:
            raise ValueError("follow() runs on the ranks of a mesh other "
                             "than 0")
        with torch.inference_mode():
            while True:
                kind, *sizes = self._header()
                if kind == _RELEASE:
                    return
                with self.timer.stage("device.dispatch"):
                    if kind == _FUSED:
                        shape = tuple(sizes[:3])
                        self._serve_slots(shape, None, self._bcast(
                            None, (len(preprocess.META_ROWS), shape[0]),
                            torch.int32))
                        continue
                    if kind == _SHELF:
                        nc, h, w, r = sizes[:4]
                        pixels = self._bcast(None, (nc, h, w), torch.uint8)
                    else:
                        nc, h, wh, n_exc, r = sizes
                        pixels = wiredecode.decode_tensors(
                            self._bcast(None, (nc, h, wh), torch.uint8),
                            self._bcast(None, (n_exc,), torch.uint8),
                            self._bcast(None, (nc,), torch.uint8))
                    self._serve_shelf(pixels, self._bcast(
                        None, (len(preprocess.META_ROWS), r), torch.int32))

    def release(self) -> None:
        """Rank 0: end the other ranks' :meth:`follow` (a no-op without a
        mesh)."""
        if self.mesh is not None and not self.follower:
            self._header(_RELEASE)

    def _host_rows(self, rows, n: int | None = None) -> np.ndarray:
        rows = rows.numpy() if torch.is_tensor(rows) else np.asarray(rows)
        if n is not None:
            rows = rows[:n]
        return unpack_probs_u16(rows, len(self.classes))

    def result_probs(self, device_result, n: int | None = None):
        """A dispatch's result as (B, num_classes) float32 probabilities
        on the host (waits for the device). With ``n`` only the first n
        rows are decoded."""
        return self._host_rows(device_result.cpu(), n)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- streams -------------------------------------------------------------

    def _start_download(self, *results: torch.Tensor):
        """Start the D2H copies of a dispatch's results into pinned host
        memory and record ONE event behind them; the drain side waits on
        the event. Returns ``(host tensor, event or None)``, with a tuple of
        host tensors when there are several results."""
        event = None
        hosts = results
        if self.device.type == "cuda":
            hosts = []
            for r in results:
                host = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                host.copy_(r, non_blocking=True)
                hosts.append(host)
            event = torch.cuda.Event()
            event.record()
        return (hosts[0] if len(hosts) == 1 else tuple(hosts)), event

    def _packed(self, tagged_rois):
        """The shelf batches of the classify stream, with ROIs over the
        network input pre-shrunk on the host (the device would downsample
        them anyway; fewer bytes to upload)."""
        return shelf.pack_shelves(
            tagged_rois, pre_shrink_to=(self.spec.target_h,
                                        self.spec.target_w),
            batch_multiple=self._batch_multiple,
            compute_modes=self.spec.border == "mode",
            slot_cap=self._shelf_slot_cap)

    def _prepared(self, tagged_rois):
        """Pack ROIs and compute host metadata on a producer thread,
        yielding ``(batch, meta)`` ready to dispatch."""
        def meta_fn(batch):
            if self.wire_codec:
                self._encode_wire(batch)
            return self._shelf_meta(batch)

        return self._produce_on_thread(self._packed(tagged_rois), meta_fn,
                                       "sykepic-shelf")

    def _produce_on_thread(self, gen, meta_fn, name: str,
                           workers: int | None = None):
        """Run a batch generator and its metadata pass off the dispatch
        thread, yielding ``(batch, meta)`` in generator order; exceptions
        relay to the consumer, and abandoning the iterator cancels the
        producers.

        Decode+pack stays sequential on one thread (the packer is a
        stateful stream); ``meta_fn`` (wire encode + resize geometry) fans
        out to a small pool, order kept by enqueuing futures. The native
        encoder and NumPy release the GIL, so the stages overlap. With
        fewer than 3 cores ``meta_fn`` runs inline on the packing thread.
        """
        if workers is None:
            workers = 2 if (os.cpu_count() or 1) >= 3 else 0

        q: queue.Queue = queue.Queue(maxsize=max(2 * workers, 4))
        done = object()
        cancel = threading.Event()  # set when the consumer goes away
        pool = (ThreadPoolExecutor(max_workers=workers,
                                   thread_name_prefix=f"{name}-meta")
                if workers else None)

        def offer(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stage2(batch):
            with self.timer.stage("host.meta"):
                return batch, meta_fn(batch)

        def produce():
            try:
                while True:
                    with self.timer.stage("host.decode+pack"):
                        batch = next(gen, None)
                    if batch is None:
                        break
                    # the bounded queue is the backpressure
                    item = pool.submit(stage2, batch) if pool else \
                        stage2(batch)
                    if not offer(item):
                        return
            except BaseException as e:  # re-raised on the consumer side
                offer(e)
                return
            offer(done)

        threading.Thread(target=produce, daemon=True, name=name).start()
        try:
            while True:
                # the dispatch thread waiting for its next prepared batch:
                # at a stream's head, the whole fill
                with self.timer.stage("engine.wait_input"):
                    item = q.get()
                    if isinstance(item, Future):
                        item = item.result()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancel.set()  # unblock the producer if we exit early
            if pool:
                pool.shutdown(wait=False, cancel_futures=True)

    def _encode_wire(self, batch):
        """Producer-thread half of the wire codec: encode the pixel tensor
        (windows or canvas) when it pays; counts encoded and raw
        dispatches."""
        pixels = (batch.windows if hasattr(batch, "windows")
                  else batch.canvas)
        with self.timer.stage("host.encode"):
            batch.wire = wirecodec.encode(pixels)
        self.timer.count("engine.wire_encoded" if batch.wire is not None
                         else "engine.wire_raw")

    def _count_dispatch(self, batch, meta) -> None:
        """Count one dispatch, once it is made: its ROIs, its slots
        (padding included), and what the network's forward does for those
        slots (:meth:`~sykepic_tpu_torch.models.resnet.Backbone.
        dispatch_counts`: Swin's ``swin.windows``, ``swin.tokens`` and
        ``swin.pad_tokens``)."""
        slots = meta.shape[1]
        self.timer.count("engine.rois", batch.n_valid)
        self.timer.count("engine.slots", slots)
        for name, n in self._slot_counts.items():
            self.timer.count(name, n * slots)

    def _drain_block(self, batch, host_rows, event):
        """Drain-thread half of a dispatch: wait for its rows, unpack the
        real ones, and return the batch's host buffers to their pools."""
        n = batch.n_valid
        with self.timer.stage("device.drain"):
            if event is not None:
                event.synchronize()
            probs = self._host_rows(host_rows, n)
        out = (np.asarray(batch.sample_idx[:n]),
               np.asarray(batch.roi_ids[:n]), probs)
        # the dispatch has finished, so its upload is long done: multi-MB
        # host buffers go back to their pools
        if batch.wire is not None:
            wirecodec.recycle_payload(batch.wire)
            batch.wire = None
        if hasattr(batch, "win_idx"):
            shelf.recycle_windows(batch)
        return out

    def classify_blocks(self, tagged_rois):
        """Classify an iterable of ``(sample_idx, roi_id, uint8 image)`` or
        :class:`~sykepic_tpu_torch.ingest.pack.RoiBlock` s, yielding
        per-batch blocks ``(sample_idx (n,), roi_ids (n,), probs (n, C))``.

        ROIs from different samples may share device batches; ordering is
        not guaranteed (sort per sample before writing CSVs).

        Pipelined: up to ``PIPELINE_DEPTH`` dispatches stay in flight. Each
        result's copy into pinned host memory starts the moment it is
        dispatched, behind a CUDA event, and one drain thread waits on the
        events in order while this thread dispatches the next batches.
        """
        drainer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sykepic-drain")
        in_flight: deque = deque()
        try:
            for batch, meta in self._prepared(tagged_rois):
                rows = self.dispatch_shelf(batch, meta)
                self._count_dispatch(batch, meta)
                host_rows, event = self._start_download(rows)
                in_flight.append(drainer.submit(
                    self._drain_block, batch, host_rows, event))
                if len(in_flight) >= PIPELINE_DEPTH:
                    yield in_flight.popleft().result()
            while in_flight:
                yield in_flight.popleft().result()
        finally:
            drainer.shutdown(wait=False, cancel_futures=True)

    def classify_rois(self, tagged_rois):
        """Per-ROI adapter over :meth:`classify_blocks`: yields
        ``(sample_idx, roi_id, probs_row)`` for every real ROI."""
        for sidx, rids, probs in self.classify_blocks(tagged_rois):
            for i in range(len(rids)):
                yield int(sidx[i]), int(rids[i]), probs[i]
        self.timer.report()

    def _prepared_fused(self, tagged_rois):
        """The slot-packed stream of the fused classify+features pass, with
        host metadata from a producer thread: no pre-shrink (area and
        biovolume are in original pixels) and no tail consolidation (moving
        a ROI to a bigger canvas changes its FFT window, so its features
        would depend on the stream)."""
        gen = pack.pack_rois(
            pack.roi_items(tagged_rois), batch_size=self.batch_size,
            buckets=None, batch_multiple=self._batch_multiple,
            pre_shrink_to=None, compute_modes=self.spec.border == "mode",
            consolidate_tails=False)

        def meta_fn(batch):
            if self.wire_codec and self.mesh is None:
                self._encode_wire(batch)
            return self._host_meta(batch)

        return self._produce_on_thread(gen, meta_fn, "sykepic-fused")

    def _dispatch_fused(self, batch, meta):
        """Start both programs of one fused dispatch on one device copy of
        the canvas: K1 + the network, and the feature program. Returns the
        two device results without waiting for them."""
        with self.timer.stage("device.dispatch"), torch.inference_mode():
            if self.mesh is not None:
                return self._lead_slots(batch.canvas, meta)
            # uploaded (or wire-decoded) ONCE, shared by both programs
            canvas = self._pixels(batch, batch.canvas)
            probs = self._forward(canvas, self._put(meta))
            feats = features_device.device_features(
                canvas, self._put(batch.heights), self._put(batch.widths))
        return probs, feats

    def classify_and_feature_rois(self, tagged_rois):
        """The fused on-device pass: each slot-packed batch is classified
        AND measured (area, biovolume, axes: :mod:`sykepic_tpu_torch.ops.
        features_device`) on the device from one canvas upload. Yields
        ``(sample_idx, roi_id, probs_row, (area, biovolume_px, major,
        minor))``; ROIs of different samples may share a batch.

        Both results of a dispatch start their copy into pinned host memory
        behind one CUDA event; up to ``FUSED_PIPELINE_DEPTH`` dispatches
        stay in flight. (The feature program reads a few convergence flags
        on the host, so a dispatch returns only once the device has
        reached them.)
        """
        in_flight: deque = deque()

        def drain(batch, host, event):
            n = batch.n_valid
            with self.timer.stage("device.drain"):
                if event is not None:
                    event.synchronize()
                probs = self._host_rows(host[0], n)
                feats = host[1][:n].numpy()
            if batch.wire is not None:  # upload done: pool the payload
                wirecodec.recycle_payload(batch.wire)
                batch.wire = None
            for i in range(n):
                yield (int(batch.sample_idx[i]), int(batch.roi_ids[i]),
                       probs[i], tuple(float(v) for v in feats[i]))

        for batch, meta in self._prepared_fused(tagged_rois):
            results = self._dispatch_fused(batch, meta)
            self._count_dispatch(batch, meta)
            host, event = self._start_download(*results)
            in_flight.append((batch, host, event))
            if len(in_flight) >= FUSED_PIPELINE_DEPTH:
                yield from drain(*in_flight.popleft())
        while in_flight:
            yield from drain(*in_flight.popleft())
        self.timer.report()

    def _zeros_wire(self, shape):
        """With the wire codec on, a forced payload of zeros but one pixel
        (which forces an exception stream), so a warm-up dispatch warms
        the decode too; else None."""
        if not self.wire_codec:
            return None
        wired = np.zeros(shape, np.uint8)
        wired[0, 0, 0] = 200
        return wirecodec.encode(wired, force=True)

    def precompile(self, shapes, fused: bool = False) -> int:
        """Warm up each shape key with one all-zeros dispatch: ``(n_windows,
        n_slots)`` pairs of classification's shelf program (snapped onto
        the ladders pack_shelves emits on), or with ``fused`` the ``(B, Hc,
        Wc)`` slot canvas shapes of the fused pass, each of which also runs
        the feature program once (building K2 and the cuFFT plans). Torch
        runs eagerly, so nothing compiles; the first dispatch of a shape
        picks its cuDNN algorithms and grows the allocator's pools. Returns
        the number of dispatches."""
        if self.mesh is not None:
            raise ValueError("precompile warms one device: build the "
                             "Classifier without a mesh")
        results = []
        if fused:
            for b, hc, wc in sorted({tuple(k) for k in shapes}):
                batch = pack.PackedBatch(
                    canvas=np.zeros((b, hc, wc), np.uint8),
                    heights=np.ones(b, np.int32),
                    widths=np.ones(b, np.int32),
                    roi_ids=np.zeros(b, np.int64),
                    sample_idx=np.zeros(b, np.int32),
                    n_valid=0,
                    modes=np.zeros(b, np.uint8),
                    wire=self._zeros_wire((b, hc, wc)),
                )
                results.extend(self._dispatch_fused(
                    batch, self._host_meta(batch)))
        else:
            slot_ceil = shelf.floor_slots(self._shelf_slot_cap,
                                          self._batch_multiple)
            keys = {(shelf.pad_nc(nc), min(shelf.pad_slots(
                r, self._batch_multiple), slot_ceil)) for nc, r in shapes}
            for nc, r in sorted(keys):
                windows = np.zeros((nc, shelf.WIN_H, shelf.WIN_W), np.uint8)
                results.append(self.dispatch_shelf(shelf.ShelfBatch(
                    windows=windows,
                    win_idx=np.zeros(r, np.int32),
                    y0=np.zeros(r, np.int32),
                    x0=np.zeros(r, np.int32),
                    heights=np.ones(r, np.int32),
                    widths=np.ones(r, np.int32),
                    roi_ids=np.zeros(r, np.int64),
                    sample_idx=np.zeros(r, np.int32),
                    n_valid=0,
                    modes=np.zeros(r, np.uint8),
                    wire=self._zeros_wire(windows.shape),
                )))
        self._sync()
        return len(results)
