"""The eval depthwise convolution over NHWC activations on the card:
wrapper around ``csrc/depthwise.cu``.

``y[n, oy, ox, c] = sum over ky, kx of weight[c, 0, ky, kx] * x[n, oy * s -
p + ky, ox * s - p + kx, c]``: a square ``k`` of 3, 5 or 7, stride ``s`` of
1 or 2, zero padding ``p = (k - 1) // 2``, no bias, float32, the channels a
multiple of 4, and ``weight`` as ``nn.Conv2d`` holds it, ``(C, 1, k, k)``.

Replaces no TPU kernel (the JAX package leaves the depthwise convolution to
XLA); the note in ``csrc/depthwise.cu`` says why it exists and what bounds
it.

:func:`depthwise` takes the plain version :func:`depthwise_plain` only for a
tensor on the CPU. On a CUDA tensor it launches the kernel, one launch a
call, or raises on what the kernel does not take. ``launches`` counts the
kernel's launches (never plain calls), so a run can show that its path went
through the kernel. :func:`takes` says which convolutions the kernel takes;
the models decide where it runs (``models/layers.py``); training keeps
cuDNN, since the kernel has no backward.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn
from torch.nn import functional as F

from . import cuda_build

launches = 0

# (k, stride) -> the (tile rows, tile columns) a warp computes, one
# instance of the kernel each (csrc/depthwise.cu lists the same)
TILES = {
    (3, 1): ((6, 6),),
    (3, 2): ((6, 6),),
    (5, 1): ((6, 6),),
    (5, 2): ((4, 4), (3, 3)),
    (7, 1): ((5, 5), (6, 6)),
}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load("depthwise").depthwise_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        _fn = fn
    return _fn


def out_size(size: int, stride: int) -> int:
    """Output rows (or columns) of ``size`` input ones: the padding keeps
    the map whole at stride 1 and halves it, rounding up, at stride 2."""
    return (size - 1) // stride + 1


def plan(k: int, stride: int, ho: int, wo: int) -> tuple[int, int]:
    """The tile of :data:`TILES` for a ``ho`` x ``wo`` output that costs
    the fewest FMAs and loads a lane over the whole map, the outputs past
    the map's edge included (ConvNeXt-T's 7x7: 5x5 tiles at 45x45 and 5x5,
    6x6 at 22x22 and 11x11)."""
    def cost(tile):
        ry, x = tile
        tiles = -(-ho // ry) * -(-wo // x)
        loads = ((ry - 1) * stride + k) * ((x - 1) * stride + k)
        return tiles * (ry * x * k * k + loads)

    return min(TILES[(k, stride)], key=cost)


def takes(conv: nn.Module) -> bool:
    """Whether the kernel takes ``conv``'s geometry: exactly
    ``nn.Conv2d`` (a tensor-parallel convolution gathers its channels
    itself), depthwise (``groups`` equal to the input and output channels,
    a multiple of 4), a square ``k`` and stride both of :data:`TILES`, zero
    padding ``(k - 1) // 2``, dilation 1. The bias is the caller's: the
    kernel adds none."""
    if type(conv) is not nn.Conv2d:
        return False
    k, s = conv.kernel_size[0], conv.stride[0]
    return (conv.groups == conv.in_channels == conv.out_channels
            and conv.in_channels % 4 == 0
            and conv.kernel_size == (k, k) and conv.stride == (s, s)
            and (k, s) in TILES and conv.padding == ((k - 1) // 2,) * 2
            and conv.dilation == (1, 1) and conv.padding_mode == "zeros")


def depthwise_plain(x: torch.Tensor, weight: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """The plain version, on any device: the kernel's sum in torch ops.
    The zero-padded input's ``k * k`` strided windows, each times its tap,
    added from zero in the taps' row-major order (the kernel adds each
    product with one rounding, fmaf; here the product and the sum round
    apart)."""
    n, h, w, c = x.shape
    k = weight.shape[-1]
    p = (k - 1) // 2
    ho, wo = out_size(h, stride), out_size(w, stride)
    xp = F.pad(x, (0, 0, p, p, p, p))
    taps = weight.reshape(c, k * k).t()
    y = x.new_zeros(n, ho, wo, c)
    for ky in range(k):
        for kx in range(k):
            window = xp[:, ky:ky + stride * (ho - 1) + 1:stride,
                        kx:kx + stride * (wo - 1) + 1:stride]
            y = y + window * taps[ky * k + kx]
    return y


def _check(x: torch.Tensor, weight: torch.Tensor, stride: int) -> None:
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise ValueError(f"x and weight must be float32, got {x.dtype} and "
                         f"{weight.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (N, H, W, C) tensor (the "
                         "NHWC view of a channels_last activation)")
    c = x.shape[-1]
    if c == 0 or c % 4:
        raise ValueError(f"the channels must be a multiple of 4, got {c}")
    if weight.device != x.device:
        raise ValueError(f"weight must lie on {x.device}, got "
                         f"{weight.device}")
    k = weight.shape[-1] if weight.dim() == 4 else 0
    if tuple(weight.shape) != (c, 1, k, k) or not weight.is_contiguous():
        raise ValueError(f"weight must be a contiguous ({c}, 1, k, k), got "
                         f"{tuple(weight.shape)}")
    if (k, stride) not in TILES:
        raise ValueError(f"k {k} at stride {stride} is not one of "
                         f"{sorted(TILES)}")
    if x.shape[1] == 0 or x.shape[2] == 0:
        raise ValueError(f"an empty map: {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on 16 bytes (16-byte copies)")


def depthwise(x: torch.Tensor, weight: torch.Tensor,
              stride: int) -> torch.Tensor:
    """The depthwise convolution of the NHWC ``x`` by ``weight`` ``(C, 1,
    k, k)`` at ``stride``, zero-padded by ``(k - 1) // 2``, without bias.
    A new contiguous NHWC tensor."""
    global launches
    if x.is_cpu:
        return depthwise_plain(x, weight, stride)
    _check(x, weight, stride)
    n, h, w, c = x.shape
    k = weight.shape[-1]
    ho, wo = out_size(h, stride), out_size(w, stride)
    y = x.new_empty(n, ho, wo, c)
    if n == 0:
        return y
    rows, cols = plan(k, stride, ho, wo)
    index = x.get_device()
    with torch.cuda.device(index):
        err = _kernel()(
            x.data_ptr(), weight.data_ptr(), y.data_ptr(), n, h, w, c, k,
            stride, rows, cols, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"depthwise kernel launch failed: CUDA error {err}")
    launches += 1
    return y
