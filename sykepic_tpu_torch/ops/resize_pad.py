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
twin calls), so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .preprocess import META_ROWS, resize_pad_plain

launches = 0
train_launches = 0

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TARGET_W = 2048  # per-column taps live in the kernel's shared memory
_MAX_NORM_CHANS = 8  # per-channel mean/std live in the kernel's shared memory
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load("resize_pad").resize_pad_launch
        fn.restype = ctypes.c_int
        i = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, i, i, i, p, i, i, i, i, i, ctypes.c_float, p, p,
                       p, p, p, p]
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
    tensor to write (a slice of a larger batch)."""
    global launches, train_launches
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

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = _kernel()(
            pixels.data_ptr(), n_win, win_h, win_w, meta.data_ptr(), n_slots,
            target_h, target_w, num_chans, _OUT_DTYPES[dtype],
            1.0 if raw else 255.0, ptr(affine),
            ptr(bright), ptr(mean), ptr(std), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize_pad kernel launch failed: CUDA error {err}")
    if train:
        train_launches += 1
    else:
        launches += 1
    return out
