"""ctypes loader for the native ingest/IO helpers (``ifcb_native.cpp``).

``lib()`` returns the loaded library or ``None`` — every caller keeps a
pure-NumPy fallback, so the framework works without a compiler; the native
path is a host-throughput optimization. The shared object is built on first
use with the bundled Makefile (``g++`` is assumed present on build hosts).

Several processes may call ``lib()`` at once on one tree (test workers,
the ranks of a multi-process run). The check, the build and the load run
under an exclusive ``flock`` on ``.buildlock`` in this directory; the build
compiles to a per-pid name, writes ``.buildhost`` and publishes the library
with ``os.replace``, so no process ever sees a half-written ``.so`` or
loads one built for another host.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SO = _HERE / "libifcb_native.so"
_SRC = _HERE / "ifcb_native.cpp"
_FP = _HERE / ".buildhost"  # CPU fingerprint the .so was compiled for
_LOCK = _HERE / ".buildlock"
_lib = None
_tried = False


def _host_fingerprint() -> str:
    """Identity of the CPU the -march=native build targets. A VM can
    migrate between hosts with different ISA extensions; running a stale .so
    built for a wider ISA would SIGILL, so a fingerprint mismatch forces
    a rebuild instead of a load."""
    import hashlib

    model = flags = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name") and not model:
                model = line.split(":", 1)[1].strip()
            # aarch64 kernels spell the ISA list "Features"
            elif line.startswith(("flags", "Features")) and not flags:
                flags = line.split(":", 1)[1].strip()
            if model and flags:
                break
    except OSError:
        pass
    if not (model or flags):
        # /proc unreadable or an exotic layout: fall back to the platform
        # identity so the guard still distinguishes ISAs instead of
        # collapsing to a constant (which would silently disable it)
        import platform

        model = platform.machine()
        flags = platform.processor()
    return hashlib.sha256(f"{model}|{flags}".encode()).hexdigest()[:16]


def _fresh(fp: str) -> bool:
    """Whether the .so exists, was built for this host (``.buildhost``)
    and is not older than its source (an older one lacks the source's newer
    symbols)."""
    try:
        return (_FP.read_text().strip() == fp
                and _SO.stat().st_mtime >= _SRC.stat().st_mtime)
    except OSError:
        return False


@contextlib.contextmanager
def _build_lock():
    """An exclusive ``flock`` on ``.buildlock``; yields False (no lock)
    where the directory is read-only, where nothing can be built anyway."""
    try:
        fd = os.open(_LOCK, os.O_RDWR | os.O_CREAT, 0o644)
    except OSError:
        yield False
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield True
    finally:
        os.close(fd)  # releases the lock


def _build(fp: str) -> bool:
    """Compile to a per-pid name (-march=native, then portable), record
    the host, publish with ``os.replace``. Call under :func:`_build_lock`."""
    tmp = _HERE / f"libifcb_native.{os.getpid()}.tmp.so"
    try:
        for extra in ((), ("PORTABLE=1",)):
            try:
                subprocess.run(
                    ["make", "-s", f"OUT={tmp.name}", *extra, tmp.name], cwd=_HERE,
                    check=True, capture_output=True, timeout=120,
                )
                break
            except Exception:
                continue
        else:
            return False
        _FP.write_text(fp + "\n")
        os.replace(tmp, _SO)
        return True
    except OSError:
        return False
    finally:
        tmp.unlink(missing_ok=True)


def lib():
    """Load (building if necessary) the native library; None on failure.
    A library that is stale (another host's, or older than its source) is
    never loaded: it is rebuilt, or None is returned."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    fp = _host_fingerprint()
    with _build_lock() as locked:
        if not _fresh(fp) and not (locked and _build(fp)):
            return None
        try:
            handle = ctypes.CDLL(str(_SO))
        except OSError:
            return None

    handle.adc_count_rows.restype = ctypes.c_longlong
    handle.adc_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    handle.adc_parse.restype = ctypes.c_longlong
    handle.adc_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
    ]
    handle.format_probs.restype = ctypes.c_longlong
    handle.format_probs.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_char_p,
        ctypes.c_longlong,
    ]
    _i32p = ctypes.POINTER(ctypes.c_int32)
    handle.shelf_pack.restype = ctypes.c_longlong
    handle.shelf_pack.argtypes = [
        _i32p, _i32p, ctypes.c_longlong,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_longlong,
        _i32p, _i32p, _i32p, _i32p, _i32p,
    ]
    handle.u8_mode.restype = ctypes.c_int32
    handle.u8_mode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
    ]
    handle.u8_modes.restype = ctypes.c_longlong
    handle.u8_modes.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), _i32p, _i32p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    handle.shelf_blit.restype = ctypes.c_longlong
    handle.shelf_blit.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), _i32p, _i32p, _i32p, _i32p, _i32p,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    handle.shelf_blit_blocks.restype = ctypes.c_longlong
    handle.shelf_blit_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), _i32p,
        ctypes.POINTER(ctypes.c_longlong), _i32p, _i32p, _i32p, _i32p,
        _i32p, ctypes.c_longlong, ctypes.c_longlong, _u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p,
    ]
    handle.wire_encode.restype = ctypes.c_longlong
    handle.wire_encode.argtypes = [
        _u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _u8p, _u8p, _u8p, ctypes.c_longlong,
    ]
    handle.png_unfilter.restype = ctypes.c_longlong
    handle.png_unfilter.argtypes = [
        _u8p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int32, _u8p,
    ]
    _lib = handle
    return _lib


def _ll_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def adc_parse(raw: bytes):
    """(widths, heights, starts) int64 arrays, or None if native unavailable."""
    handle = lib()
    if handle is None:
        return None
    n = handle.adc_count_rows(raw, len(raw))
    widths = np.zeros(n, np.int64)
    heights = np.zeros(n, np.int64)
    starts = np.zeros(n, np.int64)
    got = handle.adc_parse(raw, len(raw), _ll_ptr(widths), _ll_ptr(heights),
                           _ll_ptr(starts), n)
    if got < 0:
        return None
    return widths[:got], heights[:got], starts[:got]


def _i32_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def shelf_pack(heights, widths, win_h, win_w, max_windows, max_slots):
    """Greedy shelf placement of a pending (height, width) set — the exact
    algorithm of ``shelf._Shelver.pack``. Returns ``(item, win, y0, x0,
    n_windows)`` int32 arrays over positions into the inputs, or None if
    native is unavailable."""
    handle = lib()
    if handle is None:
        return None
    heights = np.ascontiguousarray(heights, np.int32)
    widths = np.ascontiguousarray(widths, np.int32)
    n = len(heights)
    cap = min(n, max_slots) if max_slots else n
    out_item = np.empty(cap, np.int32)
    out_win = np.empty(cap, np.int32)
    out_y = np.empty(cap, np.int32)
    out_x = np.empty(cap, np.int32)
    out_nwin = np.zeros(1, np.int32)
    got = handle.shelf_pack(
        _i32_ptr(heights), _i32_ptr(widths), n,
        win_h, win_w, max_windows, max_slots,
        _i32_ptr(out_item), _i32_ptr(out_win), _i32_ptr(out_y),
        _i32_ptr(out_x), _i32_ptr(out_nwin),
    )
    if got < 0:
        return None
    return (out_item[:got], out_win[:got], out_y[:got], out_x[:got],
            int(out_nwin[0]))


def u8_mode(img):
    """Mode pixel of a C-contiguous uint8 array (first max wins), or None
    if native is unavailable."""
    handle = lib()
    if handle is None:
        return None
    return int(handle.u8_mode(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.size,
    ))


def img_ptrs(imgs):
    """ctypes void* array over a list of C-contiguous uint8 images.

    ``img.ctypes.data`` costs ~5 us per ROI in interface-object churn, so
    callers issuing several native calls over the SAME image list (the
    shelf packer: modes + blit) build this once and pass it to both."""
    return (ctypes.c_void_p * len(imgs))(*(img.ctypes.data for img in imgs))


def u8_modes(imgs, heights, widths, ptrs=None):
    """Mode pixel of each C-contiguous uint8 ROI in one call (first max
    wins), or None if native is unavailable."""
    handle = lib()
    if handle is None:
        return None
    n = len(imgs)
    if n == 0:
        return np.zeros(0, np.uint8)
    if ptrs is None:
        ptrs = img_ptrs(imgs)
    heights = np.ascontiguousarray(heights, np.int32)
    widths = np.ascontiguousarray(widths, np.int32)
    out = np.empty(n, np.uint8)
    got = handle.u8_modes(
        ptrs, _i32_ptr(heights), _i32_ptr(widths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if got >= 0 else None


def shelf_blit(imgs, heights, widths, win_idx, y0, x0, windows, ptrs=None):
    """memcpy each uint8 ROI into its window at the packed origin; returns
    True on success, None if native is unavailable (caller falls back)."""
    handle = lib()
    if handle is None or len(imgs) == 0:
        return None if handle is None else True
    if ptrs is None:
        ptrs = img_ptrs(imgs)
    heights = np.ascontiguousarray(heights, np.int32)
    widths = np.ascontiguousarray(widths, np.int32)
    win_idx = np.ascontiguousarray(win_idx, np.int32)
    y0 = np.ascontiguousarray(y0, np.int32)
    x0 = np.ascontiguousarray(x0, np.int32)
    got = handle.shelf_blit(
        ptrs, _i32_ptr(heights), _i32_ptr(widths), _i32_ptr(win_idx),
        _i32_ptr(y0), _i32_ptr(x0), len(imgs),
        windows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        windows.shape[0], windows.shape[1], windows.shape[2],
    )
    return True if got >= 0 else None


def shelf_blit_blocks(bases, buf_idx, offsets, heights, widths,
                      win_idx, y0, x0, windows, want_modes: bool):
    """Columnar blit: ROI ``i`` reads from ``bases[buf_idx[i]] +
    offsets[i]`` — no per-ROI Python objects (the per-image pointer
    marshalling of :func:`img_ptrs` measured ~7 us/ROI on a 1-core host).
    Returns the (R,) uint8 modes array (``want_modes``), True, or None if
    native is unavailable."""
    handle = lib()
    if handle is None:
        return None
    n = len(buf_idx)
    base_ptrs = (ctypes.c_void_p * len(bases))(
        *(b.ctypes.data for b in bases))
    buf_idx = np.ascontiguousarray(buf_idx, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    heights = np.ascontiguousarray(heights, np.int32)
    widths = np.ascontiguousarray(widths, np.int32)
    win_idx = np.ascontiguousarray(win_idx, np.int32)
    y0 = np.ascontiguousarray(y0, np.int32)
    x0 = np.ascontiguousarray(x0, np.int32)
    _u8 = ctypes.POINTER(ctypes.c_uint8)
    modes = np.empty(n, np.uint8) if want_modes else None
    got = handle.shelf_blit_blocks(
        base_ptrs, _i32_ptr(buf_idx), _ll_ptr(offsets),
        _i32_ptr(heights), _i32_ptr(widths), _i32_ptr(win_idx),
        _i32_ptr(y0), _i32_ptr(x0), n, len(bases),
        windows.ctypes.data_as(_u8),
        windows.shape[0], windows.shape[1], windows.shape[2],
        modes.ctypes.data_as(_u8) if want_modes else None,
    )
    if got < 0:
        return None
    return modes if want_modes else True


def png_unfilter(rows, bpp):
    """Undo the PNG row filters of ``rows``, a C-contiguous uint8 ``(h,
    1 + stride)`` array (each row's filter byte, then its bytes): returns
    the ``(h, stride)`` image bytes, or None if native is unavailable or a
    row names an unknown filter (the caller's twin raises for it)."""
    handle = lib()
    if handle is None:
        return None
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    _u8 = ctypes.POINTER(ctypes.c_uint8)
    got = handle.png_unfilter(rows.ctypes.data_as(_u8), h, stride, bpp,
                              out.ctypes.data_as(_u8))
    return out if got == h else None


def format_probs(roi_ids, probs):
    """CSV body bytes for (roi, probabilities) rows, or None."""
    handle = lib()
    if handle is None:
        return None
    roi_ids = np.ascontiguousarray(roi_ids, np.int64)
    probs = np.ascontiguousarray(probs, np.float64)
    n, c = probs.shape
    cap = n * (24 + 8 * c)
    out = ctypes.create_string_buffer(cap)
    written = handle.format_probs(
        _ll_ptr(roi_ids),
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, c, out, cap,
    )
    if written < 0:
        return None
    return out.raw[:written]


def wire_encode(windows, cap, plane_out=None, exc_scratch=None):
    """Wire-codec encode of a (nc, h, w) uint8 windows tensor: returns
    ``(plane, flags, exc, n_entries)`` with ``exc`` sized ``n_entries``
    (one byte per entry — advance<<4 | residual>>4, dummies advancing 15x,
    global scan order), or the string ``"overflow"`` when the entry count
    exceeds ``cap`` (caller ships raw — content that noisy never pays), or
    None if the native library is unavailable. ``plane_out`` /
    ``exc_scratch`` let the caller supply (pooled) output buffers; the
    returned ``exc`` slice aliases ``exc_scratch`` when given."""
    handle = lib()
    if handle is None:
        return None
    nc, h, w = windows.shape
    windows = np.ascontiguousarray(windows)
    plane = (plane_out if plane_out is not None
             and plane_out.shape == (nc, h, w // 2)
             else np.empty((nc, h, w // 2), np.uint8))
    flags = np.empty(nc, np.uint8)
    exc = (exc_scratch if exc_scratch is not None
           and exc_scratch.size >= cap and exc_scratch.flags.c_contiguous
           else np.empty(cap, np.uint8))

    def u8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    got = handle.wire_encode(u8(windows), nc, h, w, u8(plane), u8(flags),
                             u8(exc), cap)
    if got == -2:
        return "overflow"
    if got < 0:
        return None
    return plane, flags, exc[:got], int(got)
