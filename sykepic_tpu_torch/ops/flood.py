"""K2, the constrained flood on the card: wrapper around ``csrc/flood.cu``.

Replaces ``sykepic_tpu/ops/pallas_flood.py::flood_pallas``: grow ``seed``
through ``within`` by 8-connected steps, ``x <- dilate3x3(x) & within``,
until no pixel changes or ``cap`` steps have run, with zero fill outside the
canvas. Every step reads only the previous one (Jacobi), so the kernel, its
plain version :func:`flood_plain` and the JAX flood agree at any ``cap``.

:func:`flood` takes the plain version only for tensors on the CPU. On a CUDA
tensor it launches one of the kernel's two forms, chosen by size, or raises:

- the shared-memory form, one launch per call, when an image's three
  bit-packed planes (state, next state, ``within``) fit the block's opt-in
  shared memory (:func:`shared_bytes`); it counts in ``launches``;
- the global-memory form otherwise, one launch per step plus one to start,
  reading the device's "changed" record between groups of steps; it counts
  in ``global_launches``.

``form=`` forces one of them (tests use it to reach the global form at a
small shape).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

launches = 0         # shared-memory form: one per flood call
global_launches = 0  # global-memory form: one per step, plus the start

_FORMS = (None, "shared", "global")
_fns = None
_smem_limit: dict[int, int] = {}


def _kernels():
    global _fns
    if _fns is None:
        lib = cuda_build.load("flood")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, args in (
                ("flood_smem_limit", [i]),
                ("flood_shared_launch", [p, p, p, p, i, i, i, ll, p]),
                ("flood_init_launch", [p, p, p, ll, p]),
                ("flood_step_launch", [p, p, p, p, i, i, i, i, p])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _fns = lib
    return _fns


def shared_bytes(h: int, w: int) -> int:
    """Shared memory the shared-memory form needs for one (h, w) image:
    three planes of one 32-bit word per 32 pixels of a row."""
    return 3 * h * (-(-w // 32)) * 4


def smem_limit(device: torch.device) -> int:
    """The opt-in shared memory of one block on ``device``, in bytes."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _smem_limit:
        v = _kernels().flood_smem_limit(index)
        if v <= 0:
            raise RuntimeError(f"cannot read the shared memory limit of "
                               f"cuda:{index}")
        _smem_limit[index] = v
    return _smem_limit[index]


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
    if seed.device.type != "cuda" or within.device != seed.device:
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

    ``form``: ``None`` picks by size, ``"shared"`` or ``"global"`` forces
    one (``"shared"`` raises when the image does not fit).
    """
    global launches
    cap = int(cap)
    if seed.device.type == "cpu" and within.device.type == "cpu":
        return flood_plain(seed, within, cap, return_steps)
    _check(seed, within, cap, form)
    b, h, w = seed.shape
    dev = seed.device
    if b == 0 or h == 0 or w == 0:
        out = torch.empty_like(seed)
        steps = torch.zeros(b, dtype=torch.int32, device=dev)
        return (out, steps) if return_steps else out
    fits = shared_bytes(h, w) <= smem_limit(dev)
    if form == "shared" and not fits:
        raise ValueError(f"a ({h}, {w}) image needs {shared_bytes(h, w)} B "
                         f"of shared memory, over the {smem_limit(dev)} B "
                         "a block may have")
    lib = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if form != "global" and fits:
            out = torch.empty_like(seed)
            steps = torch.empty(b, dtype=torch.int32, device=dev)
            _raise_on(lib.flood_shared_launch(
                seed.data_ptr(), within.data_ptr(), out.data_ptr(),
                steps.data_ptr(), b, h, w, cap, stream), "shared")
            launches += 1
            return (out, steps) if return_steps else out
        out, steps = _flood_global(lib, seed, within, cap, stream)
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
