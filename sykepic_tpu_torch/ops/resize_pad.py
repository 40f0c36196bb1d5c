"""K1, the resize/pad kernel on the card: wrapper around
``csrc/resize_pad.cu``.

Replaces ``sykepic_tpu/ops/pallas_preprocess.py::resize_pad_batch_pallas``
(and the einsum the JAX shelf path used instead). One launch covers every
slot of a dispatch: each slot reads its ROI straight out of the uint8
windows (shelf path) or its own canvas (slot path) at its origin, so no
per-slot copy of the windows is made.

:func:`resize_pad` takes the plain twin
(:func:`sykepic_tpu_torch.ops.preprocess.resize_pad_plain`) only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises. ``launches``
counts kernel launches (never twin calls), so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .preprocess import META_ROWS, resize_pad_plain

launches = 0

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TARGET_W = 2048  # per-column taps live in the kernel's shared memory
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load("resize_pad").resize_pad_launch
        fn.restype = ctypes.c_int
        i = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, i, i, i, p, i, i, i, i, i, p, p]
        _fn = fn
    return _fn


def resize_pad(pixels: torch.Tensor, meta: torch.Tensor, target_h: int,
               target_w: int, num_chans: int = 3,
               dtype=torch.float32) -> torch.Tensor:
    """uint8 ``pixels`` ``(N, H, W)`` + int32 slot metadata ``(10, R)``
    (rows :data:`~sykepic_tpu_torch.ops.preprocess.META_ROWS`) ->
    ``(R, target_h, target_w, num_chans)`` NHWC in ``dtype`` (float32 or
    bfloat16), values in [0, 1]."""
    global launches
    if pixels.device.type == "cpu" and meta.device.type == "cpu":
        return resize_pad_plain(pixels, meta, target_h, target_w, num_chans,
                                dtype)
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
    out = torch.empty((n_slots, target_h, target_w, num_chans), dtype=dtype,
                      device=pixels.device)
    if n_slots == 0:
        return out
    with torch.cuda.device(pixels.device):
        err = _kernel()(
            pixels.data_ptr(), n_win, win_h, win_w, meta.data_ptr(), n_slots,
            target_h, target_w, num_chans, _OUT_DTYPES[dtype],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize_pad kernel launch failed: CUDA error {err}")
    launches += 1
    return out
