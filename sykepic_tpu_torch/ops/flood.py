"""K2, the constrained flood on the card: wrapper around ``csrc/flood.cu``.

Replaces ``sykepic_tpu/ops/pallas_flood.py::flood_pallas``: grow ``seed``
through ``within`` by 8-connected steps, ``x <- dilate3x3(x) & within``,
until no pixel changes or ``cap`` steps have run, with zero fill outside the
canvas. Every step reads only the previous one (Jacobi), so the kernel, its
plain version :func:`flood_plain` and the JAX flood agree at any ``cap``.

:func:`flood` takes the plain version only for tensors on the CPU. On a CUDA
tensor it launches one of the kernel's three forms, chosen by size
(:func:`pick_form`), or raises:

- the warp form, one launch per call, for canvases up to 128 x 256: one
  warp holds one image in registers; it counts in ``warp_launches``;
- the shared-memory form, one launch per call, when an image's two
  bit-packed planes (state, vertical OR) fit the block's opt-in shared
  memory (:func:`shared_bytes`); it counts in ``launches``;
- the global-memory form otherwise, one launch per step plus one to start,
  reading the device's "changed" record between groups of steps; it counts
  in ``global_launches``.

``form=`` forces one of them (tests use it to reach every form at a small
shape).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

warp_launches = 0    # warp form: one per flood call
launches = 0         # shared-memory form: one per flood call
global_launches = 0  # global-memory form: one per step, plus the start

_FORMS = (None, "warp", "shared", "global")
WARP_ROWS = (1, 2, 4)        # rows a lane holds: h <= 32 * rows
WARP_WORDS = (1, 2, 4, 8)    # 32-pixel words a row: w <= 32 * words
SHARED_MAX_WORDS = 32 * 1024  # 32 words a thread, 1024 threads
_lib = None
_smem_limit: dict[int, int] = {}


def _kernels():
    global _lib
    if _lib is None:
        lib = cuda_build.load("flood")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, args in (
                ("flood_smem_limit", [i]),
                ("flood_warp_launch", [p, p, p, p, i, i, i, i, i, ll, p]),
                ("flood_shared_launch", [p, p, p, p, i, i, i, ll, p]),
                ("flood_init_launch", [p, p, p, ll, p]),
                ("flood_step_launch", [p, p, p, p, i, i, i, i, p])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def shared_bytes(h: int, w: int) -> int:
    """Shared memory the shared-memory form needs for one (h, w) image:
    two planes of one 32-bit word per 32 pixels of a row."""
    return 2 * h * (-(-w // 32)) * 4


def pick_form(h: int, w: int, smem_limit: int):
    """The form :func:`flood` launches for (h, w) images on a card whose
    blocks may opt into ``smem_limit`` bytes of shared memory:
    ``("warp", rows, words)`` with the smallest instance that holds the
    image, else ``"shared"`` when its planes fit, else ``"global"``."""
    words = -(-w // 32)
    rows = next((r for r in WARP_ROWS if h <= 32 * r), None)
    wide = next((k for k in WARP_WORDS if words <= k), None)
    if rows is not None and wide is not None:
        return ("warp", rows, wide)
    if shared_bytes(h, w) <= smem_limit and h * words <= SHARED_MAX_WORDS:
        return "shared"
    return "global"


def smem_limit(device: torch.device) -> int:
    """The opt-in shared memory of one block on ``device``, in bytes."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _smem_limit_of(index)


def _smem_limit_of(index: int) -> int:
    v = _smem_limit.get(index)
    if v is None:
        v = _kernels().flood_smem_limit(index)
        if v <= 0:
            raise RuntimeError(f"cannot read the shared memory limit of "
                               f"cuda:{index}")
        _smem_limit[index] = v
    return v


def flood_plain(seed: torch.Tensor, within: torch.Tensor, cap: int,
                return_steps: bool = False):
    """The plain version: the same Jacobi steps in torch ops, on any
    device. With ``return_steps`` also each image's step count (int32,
    ``(B,)``): the steps up to and including the first that changed
    nothing, at most ``cap``."""
    within_f = within.to(torch.float32)[:, None]
    state = seed.to(torch.float32)[:, None] * within_f
    steps = torch.zeros(seed.shape[0], dtype=torch.int32, device=seed.device)
    active = torch.ones(seed.shape[0], dtype=torch.bool, device=seed.device)
    for _ in range(cap):
        # max-pooling pads with -inf, so the border fill is zero
        grown = torch.nn.functional.max_pool2d(state, 3, 1, 1) * within_f
        changed = (grown != state).flatten(1).any(dim=1)
        steps += active.to(torch.int32)
        active &= changed
        state = grown
        if not bool(active.any()):
            break
    out = state[:, 0] > 0.5
    return (out, steps) if return_steps else out


def _check(seed: torch.Tensor, within: torch.Tensor, cap: int, form) -> None:
    if not seed.is_cuda or within.get_device() != seed.get_device():
        raise ValueError(
            f"seed ({seed.device}) and within ({within.device}) must lie on "
            "one CUDA device (or both on the CPU)")
    for name, t in (("seed", seed), ("within", within)):
        if t.dtype != torch.bool or t.dim() != 3:
            raise ValueError(f"{name} must be bool (B, H, W), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seed.shape != within.shape:
        raise ValueError(f"seed {tuple(seed.shape)} and within "
                         f"{tuple(within.shape)} differ in shape")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if form not in _FORMS:
        raise ValueError(f"form must be one of {_FORMS}, got {form!r}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flood kernel ({what}) launch failed: CUDA error "
                           f"{err}")


def flood(seed: torch.Tensor, within: torch.Tensor, cap: int,
          return_steps: bool = False, form: str | None = None):
    """8-connected flood of bool ``seed`` ``(B, H, W)`` through bool
    ``within``; returns the bool mask and, with ``return_steps``, each
    image's step count (int32 ``(B,)``, as :func:`flood_plain` counts).

    ``form``: ``None`` picks by size (:func:`pick_form`); ``"warp"``,
    ``"shared"`` or ``"global"`` forces one (``"warp"`` and ``"shared"``
    raise when the image does not fit them).
    """
    global warp_launches, launches
    cap = int(cap)
    if seed.is_cpu and within.is_cpu:
        return flood_plain(seed, within, cap, return_steps)
    _check(seed, within, cap, form)
    b, h, w = seed.shape
    index = seed.get_device()
    if b == 0 or h == 0 or w == 0:
        out = torch.empty_like(seed)
        steps = torch.zeros(b, dtype=torch.int32, device=seed.device)
        return (out, steps) if return_steps else out
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return flood(seed, within, cap, return_steps, form)
    picked = pick_form(h, w, _smem_limit_of(index))
    kind = picked if isinstance(picked, str) else picked[0]
    if form == "warp" and kind != "warp":
        raise ValueError(f"a ({h}, {w}) image is past the warp form's "
                         f"{32 * WARP_ROWS[-1]} x {32 * WARP_WORDS[-1]}")
    if form == "shared" and kind == "global":
        raise ValueError(f"a ({h}, {w}) image needs {shared_bytes(h, w)} B "
                         f"of shared memory, over the {_smem_limit_of(index)}"
                         " B a block may have")
    kind = form or kind
    lib = _kernels()
    # host cost per call: the opt-in limit is read once per device and the
    # ctypes functions are looked up once (ctypes keeps them on the library)
    stream = torch.cuda.current_stream(index).cuda_stream
    if kind == "global":
        out, steps = _flood_global(lib, seed, within, cap, stream)
        return (out, steps) if return_steps else out
    out = torch.empty_like(seed)
    steps = (torch.empty(b, dtype=torch.int32, device=seed.device)
             if return_steps else None)
    steps_ptr = None if steps is None else steps.data_ptr()
    if kind == "warp":
        rows, words = picked[1:]
        _raise_on(lib.flood_warp_launch(
            seed.data_ptr(), within.data_ptr(), out.data_ptr(), steps_ptr,
            b, h, w, rows, words, cap, stream), "warp")
        warp_launches += 1
    else:
        _raise_on(lib.flood_shared_launch(
            seed.data_ptr(), within.data_ptr(), out.data_ptr(), steps_ptr,
            b, h, w, cap, stream), "shared")
        launches += 1
    return (out, steps) if return_steps else out


def _flood_global(lib, seed, within, cap: int, stream):
    """The global-memory form: one launch per step. Between groups of
    steps the host reads the last step that changed any image; when the
    newest step changed nothing the flood has converged (later steps would
    change nothing either). Groups grow from 8 to 256 steps and never run
    past ``cap``."""
    global global_launches
    b, h, w = seed.shape
    cur = torch.empty_like(seed)
    nxt = torch.empty_like(seed)
    last = torch.zeros(b, dtype=torch.int32, device=seed.device)
    _raise_on(lib.flood_init_launch(seed.data_ptr(), within.data_ptr(),
                                    cur.data_ptr(), seed.numel(), stream),
              "init")
    global_launches += 1
    done, group = 0, 8
    while done < cap:
        for _ in range(min(group, cap - done)):
            done += 1
            _raise_on(lib.flood_step_launch(
                cur.data_ptr(), within.data_ptr(), nxt.data_ptr(),
                last.data_ptr(), b, h, w, done, stream), "step")
            global_launches += 1
            cur, nxt = nxt, cur
        if int(last.max()) < done:
            break
        group = min(2 * group, 256)
    # an image stops at the first step that changed nothing
    return cur, torch.clamp(last + 1, max=cap)
