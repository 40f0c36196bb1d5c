"""ConvNeXt's eval LayerNorm over the channel axis on the card: wrapper
around ``csrc/layernorm.cu``.

``y[r, :] = LN(x[r, :] + pre_bias) * weight + bias`` over the last axis of
rows stored contiguously (an NHWC activation's channels), with the
preceding convolution's bias ``pre_bias`` optional: the convolution then
runs without its bias, and the bias costs no broadcast pass of its own.

Replaces no TPU kernel (XLA fuses the JAX package's LayerNorm); the note in
``csrc/layernorm.cu`` says why it exists and what bounds it.

:func:`layernorm` takes the plain version :func:`layernorm_plain` only for
a tensor on the CPU. On a CUDA tensor it launches the kernel, one launch a
call, or raises on what the kernel does not take. ``launches`` counts the
kernel's launches (never plain calls), so a run can show that its path went
through the kernel. The model decides where the kernel runs
(``models/convnext.py``); training keeps ATen's LayerNorm, since the kernel
has no backward.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

launches = 0

MAX_CHANNELS = 1536  # 32 lanes x 12 float4 (csrc/layernorm.cu kMaxVecs)
_FEW_VECS = 4  # float4 a lane before a row takes more lanes
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load("layernorm").layernorm_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i,
                       ctypes.c_float, p]
        _fn = fn
    return _fn


def plan(channels: int) -> tuple[int, int]:
    """``(lanes, per_lane)`` for rows of ``channels`` values: the fewest
    lanes a row (a power of two, at most a warp's 32) that leave each lane
    at most four float4, and the float4 a lane then holds (96 channels:
    8 lanes x 3; 768: 32 x 6; 1536: 32 x 12)."""
    vecs = channels // 4
    lanes = 1
    while lanes < 32 and -(-vecs // lanes) > _FEW_VECS:
        lanes *= 2
    return lanes, -(-vecs // lanes)


def layernorm_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    pre_bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version, on any device: the kernel's steps in torch ops.
    The sum with ``pre_bias`` rounded once, the mean over the last axis,
    the mean of the squared deviations from it, their reciprocal root with
    ``eps`` inside, then scale and shift."""
    if pre_bias is not None:
        x = x + pre_bias
    c = x.shape[-1]
    d = x - x.sum(-1, keepdim=True) / c
    var = (d * d).sum(-1, keepdim=True) / c
    return d * torch.rsqrt(var + eps) * weight + bias


def _check(x, weight, bias, pre_bias) -> None:
    c = x.shape[-1] if x.dim() else 0
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous over its rows (an NHWC "
                         "activation's channel axis)")
    if not (0 < c <= MAX_CHANNELS and c % 4 == 0):
        raise ValueError(f"the last axis must be a multiple of 4 up to "
                         f"{MAX_CHANNELS}, got {c}")
    for name, t in (("weight", weight), ("bias", bias),
                    ("pre_bias", pre_bias)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({c},), got "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias),
                    ("pre_bias", pre_bias)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (float4 "
                             "loads)")


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float, pre_bias: torch.Tensor | None = None
              ) -> torch.Tensor:
    """LayerNorm of ``x + pre_bias`` over the last axis, scaled by
    ``weight`` and shifted by ``bias``; float32, the last axis a multiple
    of 4 up to :data:`MAX_CHANNELS`. A new contiguous tensor."""
    global launches
    if x.is_cpu:
        return layernorm_plain(x, weight, bias, eps, pre_bias)
    _check(x, weight, bias, pre_bias)
    y = torch.empty_like(x)
    c = x.shape[-1]
    rows = x.numel() // c
    if rows == 0:
        return y
    index = x.get_device()
    lanes, per_lane = plan(c)
    with torch.cuda.device(index):
        err = _kernel()(
            x.data_ptr(), None if pre_bias is None else pre_bias.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, c, lanes,
            per_lane, float(eps), torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layernorm kernel launch failed: CUDA error {err}")
    launches += 1
    return y
