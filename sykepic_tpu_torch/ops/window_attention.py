"""Swin's shifted-window attention on the card, read from the unpadded NHWC
map: wrapper around ``csrc/window_attention.cu``.

``window_attention(qkv, qkv_bias, table, heads, shifts)`` is torchvision's
``shifted_window_attention`` of one block from the product with ``qkv`` to
the input of ``proj``, on the map as it is: ``qkv`` is ``F.linear`` of the
block's normed NHWC tokens ``(B, H, W, C)``, ``(B, H, W, 3C)``; the windows
are those of the map padded at the bottom and right to multiples of
:data:`WINDOW` and rolled by minus ``shifts``; a padded token is a key and
a value with the k and v of a zero token, which are ``qkv_bias``'s; the
scores are q.k times ``head_dim ** -0.5`` plus the head's relative-position
bias from ``table`` ``((2 window - 1) ** 2, heads)`` plus, along a shifted
axis, -100 between tokens of different regions; then the softmax and the
product with v. The result is ``(B, H, W, C)``, heads in channel order, at
each query's own token: no pad, roll, partition, reverse or crop, and no
padded query row.

Replaces no TPU kernel (the JAX package has no Swin); the note in
``csrc/window_attention.cu`` says why it exists and what bounds it.

:func:`window_attention` takes the plain version
:func:`window_attention_plain` only for a tensor on the CPU. On a CUDA
tensor it launches the kernel, one launch a call, or raises on what the
kernel does not take (a window of :data:`WINDOW`, heads of
:data:`HEAD_DIM`, float32). ``launches`` counts the kernel's launches
(never plain calls), so a run can show that its path went through the
kernel. The model decides where it runs (``models/swin.py``); training
keeps SDPA, since the kernel has no backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

launches = 0

WINDOW = 7
HEAD_DIM = 32
REGION_MASK = -100.0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load("window_attention").window_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float,
                       p]
        _fn = fn
    return _fn


def plan(heads: int) -> int:
    """Heads a block for ``heads``, one query row a thread: 3 where 3
    divides ``heads`` (Swin-T's and Swin-S's 3 to 24: 147 query rows on 160
    threads), else 1 (Swin-B's 4 to 32), the kernel's two instances."""
    return 3 if heads % 3 == 0 else 1


def region_mask(pad_h: int, pad_w: int, window: int,
                shifts: tuple[int, int], device) -> torch.Tensor:
    """``(windows, N, N)`` float32: -100 between tokens of different
    regions of each window of the padded, rolled ``pad_h x pad_w`` map, 0
    elsewhere (torchvision's region mask). Along a shifted axis of ``n``
    the rows before ``n - window`` are region 0, those before ``n - shift``
    region 1, the rest region 2; an axis not shifted is one region. Made on
    ``device``: a copy from the host would wait for the device's queue."""
    def regions(n, shift):
        r = torch.arange(n, device=device)
        if not shift:
            return torch.zeros_like(r)
        return (r >= n - window).long() + (r >= n - shift).long()

    ids = (regions(pad_h, shifts[0])[:, None] * 3
           + regions(pad_w, shifts[1])).view(
        pad_h // window, window, pad_w // window, window).permute(
        0, 2, 1, 3).reshape(-1, window * window)
    return (ids[:, None, :] != ids[:, :, None]) * REGION_MASK


def window_attention_plain(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                           table: torch.Tensor, heads: int,
                           shifts: tuple[int, int]) -> torch.Tensor:
    """The plain version, on any device and at any window and head size:
    the kernel's function in torch ops. The map padded with
    ``qkv_bias`` (the qkv of a zero token), rolled and cut into windows;
    q.k scaled, plus the bias ``table`` gathered by each query's and key's
    offset, plus the region mask; softmax; times v; the windows, the roll
    and the padding undone."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    win = (math.isqrt(table.shape[0]) + 1) // 2
    n = win * win
    ph, pw = -(-h // win) * win, -(-w // win) * win
    sh, sw = shifts
    full = qkv_bias.expand(b, ph, pw, c3).clone()
    full[:, :h, :w] = qkv
    full = torch.roll(full, (-sh, -sw), (1, 2))
    nh, nw = ph // win, pw // win
    # (3, B, windows, heads, N, d)
    q, k, v = full.view(b, nh, win, nw, win, 3, heads, d).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nh * nw, heads, n, d)
    pos = torch.arange(n, device=qkv.device)
    ys, xs = pos // win, pos % win
    index = ((ys[:, None] - ys[None] + win - 1) * (2 * win - 1)
             + xs[:, None] - xs[None] + win - 1)
    bias = table[index].permute(2, 0, 1)  # (heads, N, N)
    region = region_mask(ph, pw, win, shifts, qkv.device)
    scores = (q @ k.transpose(-1, -2)) * d ** -0.5 + (
        bias[None] + region[:, None].to(qkv.dtype))
    y = torch.softmax(scores, dim=-1) @ v
    y = y.view(b, nh, nw, heads, win, win, d).permute(
        0, 1, 4, 2, 5, 3, 6).reshape(b, ph, pw, c)
    y = torch.roll(y, (sh, sw), (1, 2))
    return y[:, :h, :w].contiguous()


def _check(qkv, qkv_bias, table, heads, shifts) -> None:
    if qkv.dim() != 4 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous (B, H, W, 3C) tensor")
    b, h, w, c3 = qkv.shape
    if c3 != 3 * heads * HEAD_DIM:
        raise ValueError(f"qkv must hold 3 x {heads} heads of {HEAD_DIM}, "
                         f"got {c3} channels")
    if h == 0 or w == 0:
        raise ValueError(f"an empty map: {tuple(qkv.shape)}")
    if table.shape != ((2 * WINDOW - 1) ** 2, heads):
        raise ValueError(f"table must be ({(2 * WINDOW - 1) ** 2}, {heads}) "
                         f"(a window of {WINDOW}), got {tuple(table.shape)}")
    if qkv_bias is None or tuple(qkv_bias.shape) != (c3,):
        raise ValueError(f"qkv_bias must be ({c3},)")
    for name, t in (("qkv", qkv), ("qkv_bias", qkv_bias), ("table", table)):
        if t.device != qkv.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {qkv.device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("qkv", qkv), ("qkv_bias", qkv_bias)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (16-byte "
                             "copies)")
    if not all(0 <= s < WINDOW for s in shifts):
        raise ValueError(f"shifts must lie in [0, {WINDOW}), got {shifts}")


def window_attention(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                     table: torch.Tensor, heads: int,
                     shifts: tuple[int, int]) -> torch.Tensor:
    """The shifted-window attention of ``qkv`` ``(B, H, W, 3C)`` on its
    unpadded map, with ``qkv_bias`` for padded keys, the bias ``table``,
    ``heads`` heads and the roll ``shifts`` ``(shift_h, shift_w)``. A new
    contiguous ``(B, H, W, C)`` tensor."""
    global launches
    if qkv.is_cpu:
        return window_attention_plain(qkv, qkv_bias, table, heads, shifts)
    _check(qkv, qkv_bias, table, heads, shifts)
    b, h, w, c3 = qkv.shape
    y = qkv.new_empty(b, h, w, c3 // 3)
    if b == 0:
        return y
    index = qkv.get_device()
    with torch.cuda.device(index):
        err = _kernel()(
            qkv.data_ptr(), qkv_bias.data_ptr(), table.data_ptr(),
            y.data_ptr(), b, h, w, c3 // 3, heads, shifts[0], shifts[1],
            plan(heads), HEAD_DIM ** -0.5,
            torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return y
