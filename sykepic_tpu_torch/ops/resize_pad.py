"""K1, the resize/pad kernel on the card: wrapper around
``csrc/resize_pad.cu``.

Replaces ``sykepic_tpu/ops/pallas_preprocess.py::resize_pad_batch_pallas``
(and the einsum the JAX shelf path and train step used instead). One launch
covers every slot of a dispatch: each slot reads its ROI straight out of the
uint8 windows (shelf path), its own canvas (slot path) or a row of a
device-resident training store, at its origin, so no per-slot copy of the
pixels is made.

The train form (``affine``, ``bright``, ``mean``/``std``) folds the training
augmentations and the ImageNet normalisation into the same launch; see
``csrc/resize_pad.cu``.

:func:`resize_pad` takes the plain twin
(:func:`sykepic_tpu_torch.ops.preprocess.resize_pad_plain`) only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises. ``launches``
counts eval-form launches and ``train_launches`` train-form launches (never
twin calls), so a run can show that its path went through the kernel;
``vector_launches`` counts the launches of either form whose output took the
vector store path instead of TMA bulk stores. :func:`plan` decides each
launch's tile rows, threads, store path and shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import cuda_build
from .preprocess import META_ROWS, resize_pad_plain

launches = 0
train_launches = 0
vector_launches = 0  # launches of either form that took the vector store

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_MAX_TARGET_W = 2048  # per-column taps live in the kernel's shared memory
_MAX_NORM_CHANS = 8  # per-channel mean/std live in the kernel's shared memory
# dynamic shared memory one block may take on an H100 (227 KB)
_SMEM_LIMIT = 232_448
_STAGE_BYTES = 16_384  # output bytes a staging buffer aims to hold
_MAX_THREADS = 256  # a block's threads
_MAX_LANES = 4  # threads that share a column group, on interleaved rows
_GROUP = 4  # adjacent output columns a thread makes (csrc/resize_pad.cu kG)
_TAPS_BYTES = 16  # one row's or column's taps (csrc/resize_pad.cu::Taps)
_LEVELS = 256  # brightness levels after the floor: the level table's rows
STORES = {"bulk": 0, "vector": 1}
_fn = None


class Plan(NamedTuple):
    """How one launch of the kernel runs (``csrc/resize_pad.cu``)."""

    tile_rows: int  # output rows a staged tile holds
    lanes: int  # threads a column group, each taking every lanes-th row
    threads: int  # a block's threads: lanes x the threads across groups
    store: str  # "bulk" (TMA bulk stores) or "vector" (16-byte stores)
    stage_bytes: int  # one of the two staging buffers
    smem_bytes: int  # all the block's dynamic shared memory


def plan(target_h: int, target_w: int, num_chans: int, dtype,
         out_ptr: int = 0, bright: bool = False, norm: bool = False) -> Plan:
    """The launch plan for an output ``(R, target_h, target_w, num_chans)``
    in ``dtype`` at address ``out_ptr``, with brightness (the level table)
    and normalisation or without.

    A tile's span is a TMA bulk store where every span starts on 16 bytes
    and holds a multiple of 16 (an aligned ``out``, ``target_h`` rows of a
    slot a multiple of 16 bytes, and tile rows chosen so); else the vector
    path (also where the fewest rows a bulk tile can take do not fit the
    shared-memory budget). Tile rows fill about ``_STAGE_BYTES`` a buffer,
    fewer where the budget needs it; raises for an output the budget cannot
    take. Plans are kept: ``out_ptr`` counts only by its alignment."""
    return _plan(target_h, target_w, num_chans, dtype, out_ptr % 16 == 0,
                 bool(bright), bool(norm))


@functools.lru_cache(maxsize=64)
def _plan(target_h, target_w, num_chans, dtype, out_aligned, bright,
          norm) -> Plan:
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"unsupported output dtype {dtype}")
    if not (0 < target_w <= _MAX_TARGET_W and 0 < target_h and num_chans > 0):
        raise ValueError(f"unsupported target {target_h}x{target_w}x"
                         f"{num_chans}")
    elem = _ELEM_BYTES[dtype]
    row = target_w * num_chans * elem
    aligned = out_aligned and target_h * row % 16 == 0
    # a thread makes _GROUP adjacent columns of `lanes` interleaved rows
    groups = -(-target_w // _GROUP)
    across = min(groups, _MAX_THREADS)
    lanes = max(1, min(_MAX_LANES, _MAX_THREADS // across))
    fixed = (_TAPS_BYTES * (groups * _GROUP + target_h)
             + 2 * _MAX_NORM_CHANS * 4
             + (_LEVELS * (num_chans if norm else 1) * elem if bright else 0))

    def fit(path):
        # bulk: tile rows whose bytes are a multiple of 16; the vector path
        # stages a span at its address's offset mod 16. Rows a multiple of
        # the lanes where the budget allows.
        step = 16 // math.gcd(row, 16) if path == "bulk" else 1
        unit = step * lanes // math.gcd(step, lanes)
        rows = max(unit, round(_STAGE_BYTES / row / unit) * unit)
        rows = min(rows, -(-target_h // unit) * unit)
        while True:
            stage = (rows * row if path == "bulk"
                     else -(-(rows * row + 16) // 16) * 16)
            total = 2 * stage + fixed
            if total <= _SMEM_LIMIT or rows <= step:
                return rows, stage, total
            rows -= step

    store = "bulk" if aligned else "vector"
    if store == "bulk" and fit("bulk")[2] > _SMEM_LIMIT:
        store = "vector"  # the fewest rows a bulk tile takes do not fit
    rows, stage, total = fit(store)
    if total > _SMEM_LIMIT:
        raise ValueError(f"an output of {target_h}x{target_w}x{num_chans} "
                         f"{dtype} needs {total} bytes of shared memory, "
                         f"more than the {_SMEM_LIMIT} a block may take")
    return Plan(rows, lanes, lanes * across, store, stage, total)


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load("resize_pad").resize_pad_launch
        fn.restype = ctypes.c_int
        i = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, i, i, i, p, i, i, i, i, i, ctypes.c_float, p, p,
                       p, p, p, i, i, i, i, i, i, p]
        _fn = fn
    return _fn


def _f32_input(name, t, shape, device):
    """A train-form input: None, or float32 of ``shape`` on ``device``."""
    if t is None:
        return None
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t


def resize_pad(pixels: torch.Tensor, meta: torch.Tensor, target_h: int,
               target_w: int, num_chans: int = 3, dtype=torch.float32,
               affine=None, bright=None, mean=None, std=None,
               out=None, raw: bool = False) -> torch.Tensor:
    """uint8 ``pixels`` ``(N, H, W)`` + int32 slot metadata ``(10, R)``
    (rows :data:`~sykepic_tpu_torch.ops.preprocess.META_ROWS`) ->
    ``(R, target_h, target_w, num_chans)`` NHWC in ``dtype`` (float32 or
    bfloat16), values in [0, 1] (before normalisation), or on the 0-255
    scale with ``raw`` (the eval form the rotation route warps).

    Train form: ``affine`` float32 ``(4, R)`` rows ``(a_y, b_y, a_x, b_x)``
    make the sampling coordinate ``a * i + b``; ``bright`` float32 ``(R,)``
    applies brightness, clip and floor on the 0-255 scale; ``mean``/``std``
    float32 ``(num_chans,)`` normalise after the division by 255. ``out``,
    when given, is the contiguous ``(R, target_h, target_w, num_chans)``
    tensor to write (a slice of a larger batch); its alignment picks the
    kernel's store path (:func:`plan`)."""
    global launches, train_launches, vector_launches
    train = affine is not None or bright is not None or mean is not None
    if (mean is None) != (std is None):
        raise ValueError("mean and std go together")
    if pixels.device.type == "cpu" and meta.device.type == "cpu":
        res = resize_pad_plain(pixels, meta, target_h, target_w, num_chans,
                               dtype, affine=affine, bright=bright,
                               mean=mean, std=std, raw=raw)
        if out is None:
            return res
        out.copy_(res)
        return out
    if pixels.device.type != "cuda" or meta.device != pixels.device:
        raise ValueError(
            f"pixels ({pixels.device}) and meta ({meta.device}) must lie on "
            "one CUDA device (or both on the CPU)")
    if pixels.dtype != torch.uint8 or pixels.dim() != 3:
        raise ValueError(f"pixels must be uint8 (N, H, W), got "
                         f"{pixels.dtype} {tuple(pixels.shape)}")
    if (meta.dtype != torch.int32 or meta.dim() != 2
            or meta.shape[0] != len(META_ROWS)):
        raise ValueError(f"meta must be int32 ({len(META_ROWS)}, R), got "
                         f"{meta.dtype} {tuple(meta.shape)}")
    if not (pixels.is_contiguous() and meta.is_contiguous()):
        raise ValueError("pixels and meta must be contiguous")
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"unsupported output dtype {dtype}")
    if not (0 < target_w <= _MAX_TARGET_W and 0 < target_h and num_chans > 0):
        raise ValueError(f"unsupported target {target_h}x{target_w}x"
                         f"{num_chans}")
    n_win, win_h, win_w = pixels.shape
    n_slots = meta.shape[1]
    if n_win == 0 and n_slots:
        raise ValueError("slots reference an empty pixel tensor")
    if win_h * win_w >= 2 ** 31:
        raise ValueError("a pixel plane must hold fewer than 2**31 bytes")
    dev = pixels.device
    affine = _f32_input("affine", affine, (4, n_slots), dev)
    bright = _f32_input("bright", bright, (n_slots,), dev)
    mean = _f32_input("mean", mean, (num_chans,), dev)
    std = _f32_input("std", std, (num_chans,), dev)
    if mean is not None and num_chans > _MAX_NORM_CHANS:
        raise ValueError(f"normalisation takes at most {_MAX_NORM_CHANS} "
                         "channels")
    shape = (n_slots, target_h, target_w, num_chans)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    elif (tuple(out.shape) != shape or out.dtype != dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous {dtype} {shape} on {dev}, "
                         f"got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if n_slots == 0:
        return out
    pl = plan(target_h, target_w, num_chans, dtype, out.data_ptr(),
              bright=bright is not None, norm=mean is not None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = _kernel()(
            pixels.data_ptr(), n_win, win_h, win_w, meta.data_ptr(), n_slots,
            target_h, target_w, num_chans, _OUT_DTYPES[dtype],
            1.0 if raw else 255.0, ptr(affine),
            ptr(bright), ptr(mean), ptr(std), out.data_ptr(),
            pl.tile_rows, pl.lanes, pl.threads, STORES[pl.store],
            pl.stage_bytes,
            pl.smem_bytes, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize_pad kernel launch failed: CUDA error {err}")
    if train:
        train_launches += 1
    else:
        launches += 1
    if pl.store == "vector":
        vector_launches += 1
    return out
