"""Batched on-device geometry features: a (B, ch, cw) uint8 ROI canvas
batch goes from pixels to (area, biovolume, major/minor axis) without
leaving the device.

The port of ``sykepic_tpu/ops/features_device.py``; each function keeps
its JAX name and its pipeline (that module's docstring gives the
algorithm and its documented deviations from the host features):

- per-image **phase congruency** (Kovesi ``M + m``) from a log-Gabor/spread
  filter bank built once per canvas shape in numpy and uploaded once per
  device, with ``torch.fft`` (cuFFT on the card) for every canvas size;
- **hysteresis** (0.2 / 0.08) as a flood of the strong mask through the
  weak mask;
- dilate by a radius-2 disk, fill holes, erode twice (MATLAB borders),
  union with the dark mask (``img <= 0.7 * otsu``), fill again;
- the **largest blob** of four candidate floods from the deepest
  unclaimed pixels, then area, ``sum(4D - 3)`` biovolume and the ellipse
  axes from masked moments, with a chamfer 3-4 distance.

Every flood (seven per batch) goes through :func:`_flood`, which is K2
(:mod:`sykepic_tpu_torch.ops.flood`) on a CUDA tensor and its plain version
on a CPU tensor. Everything runs in float32 whatever the classifier's
dtype, as in JAX.

Where the port differs from the JAX code, and why:

- The DFT-by-matmul and the radix median were TPU workarounds. Here the
  transforms are ``torch.fft.fft2/ifft2`` and the median is ``torch.sort``
  (the same order statistics, bit for bit). Phase congruency then differs
  from JAX's by float rounding (bounded in the tests at 2e-3).
- The convergence loops of :func:`chamfer_distance` and
  :func:`_replicate_fill` run ``_CHECK_EVERY`` steps between reads of
  their "changed" test (each read is a host sync on the card), never more
  than the cap in total. Both maps are idempotent at their fixed point, so
  the extra steps change nothing.
- :func:`batched_otsu` takes its cumulative sums in int64 and rounds them
  to float32 once; JAX sums in float32. Both are exact, so equal, while
  ``sum(hist * level)`` < 2**24 (about 65k pixels per image); above that
  the port's sums are the correctly rounded ones.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import flood as flood_mod

# Hysteresis thresholds on the phase-congruency moment sum (M + m) and the
# dark-mask scale on the Otsu level: copies of
# sykepic_tpu/compute/features.py:65-67, calibrated there against the golden
# fixture CSV.
HYST_HIGH = 0.2
HYST_LOW = 0.08
DARK_OTSU_SCALE = 0.7

# Euclidean disk of radius 2 offsets (matches compute.features.DISK2)
_DISK2_OFFSETS = [
    (dy, dx)
    for dy in range(-2, 3)
    for dx in range(-2, 3)
    if dy * dy + dx * dx <= 4
]

# Steps of a convergence loop between two reads of its "changed" test.
_CHECK_EVERY = 8


def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as one IEEE division on every device: CUDA turns
    a division by a Python scalar into a multiply by its reciprocal."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _valid(heights, widths, ch: int, cw: int):
    dev = heights.device
    rows = torch.arange(ch, device=dev)[None, :, None]
    cols = torch.arange(cw, device=dev)[None, None, :]
    return (rows < heights[:, None, None]) & (cols < widths[:, None, None])


def batched_otsu(canvas, heights, widths):
    """Per-image Otsu threshold over the valid region: ``(t, valid)``,
    ``t`` int32 ``(B,)``. The histogram counts ``b*256 + pixel`` keys
    (JAX's one-hot was a TPU measurement); ``argmax`` returns the first
    maximum, as JAX's does."""
    b, ch, cw = canvas.shape
    valid = _valid(heights, widths, ch, cw)
    # padding pixels count in a spare bin past the last image's; an
    # index_add_ keeps the histogram free of host syncs on the card
    keys = torch.where(
        valid, torch.arange(b, device=canvas.device)[:, None, None] * 256
        + canvas.to(torch.int64), b * 256).flatten()
    hist = torch.zeros(b * 256 + 1, dtype=torch.int64, device=canvas.device)
    hist = hist.index_add_(0, keys, torch.ones_like(keys))[:-1].reshape(b, 256)
    level = torch.arange(256, device=canvas.device)
    # exact integer cumulative sums, rounded to float32 once
    w_b = torch.cumsum(hist, dim=1).to(torch.float32)
    sum_b = torch.cumsum(hist * level, dim=1).to(torch.float32)
    total = w_b[:, -1:]
    sum_all = sum_b[:, -1:]
    w_f = total - w_b
    mu_b = torch.where(w_b > 0, sum_b / w_b, 0.0)
    mu_f = torch.where(w_f > 0, (sum_all - sum_b) / w_f, 0.0)
    var = torch.where((w_b > 0) & (w_f > 0),
                      w_b * w_f * (mu_b - mu_f) ** 2, -1.0)
    return torch.argmax(var, dim=1).to(torch.int32), valid


def _dilate3(x):
    """3x3 dilation (max) of a (B, H, W) float mask; outside is -inf."""
    return F.max_pool2d(x[:, None], 3, 1, 1)[:, 0]


def _flood(seed, within, iterations: int):
    """Grow bool ``seed`` through bool ``within`` by 8-connected steps until
    nothing changes or ``iterations`` steps pass: K2 on the card, its plain
    version on the CPU (:func:`sykepic_tpu_torch.ops.flood.flood`)."""
    return flood_mod.flood(seed.contiguous(), within.contiguous(),
                           iterations)


def _shift(mask, dy: int, dx: int, pad_value: bool):
    """``mask`` moved so that pixel (y, x) reads (y + dy, x + dx); outside
    reads ``pad_value``."""
    _, h, w = mask.shape
    padded = F.pad(mask.to(torch.uint8), (2, 2, 2, 2),
                   value=int(pad_value)).to(torch.bool)
    return padded[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]


def dilate_disk2(mask, valid):
    """Radius-2 disk dilation confined to the valid region."""
    out = torch.zeros_like(mask)
    for dy, dx in _DISK2_OFFSETS:
        out = out | _shift(mask, dy, dx, False)
    return out & valid


def erode_disk2(mask, valid, iterations: int = 1):
    """Radius-2 disk erosion with MATLAB border semantics: everything
    outside the valid region counts as foreground (imerode pads with 1)."""
    m = mask | ~valid
    for _ in range(iterations):
        acc = torch.ones_like(m)
        for dy, dx in _DISK2_OFFSETS:
            acc = acc & _shift(m, dy, dx, True)
        m = acc
    return m & valid


def fill_holes(mask, valid, iterations: int):
    """Fill holes within the valid region: flood background from the
    valid-region border; valid pixels unreachable through ``~mask`` are
    holes and join the mask."""
    _, h, w = mask.shape
    free_or_invalid = ~mask | ~valid
    # seeds: the invalid region plus the canvas border (so the flood starts
    # even when the canvas has no padding)
    border = torch.zeros((1, h, w), dtype=torch.bool, device=mask.device)
    border[:, 0, :] = border[:, -1, :] = True
    border[:, :, 0] = border[:, :, -1] = True
    seed = (~valid | border) & free_or_invalid
    bg = _flood(seed, free_or_invalid, iterations)
    return (mask | ~bg) & valid


def chamfer_distance(mask, iterations: int, valid=None):
    """Chamfer 3-4 distance-to-background (scaled back by 1/3), computed as
    convergence-checked min-plus relaxation sweeps. ``mask``: (B, H, W)
    bool. Out-of-image pixels (beyond ``valid`` and beyond the canvas
    border) are NOT background (see the JAX docstring)."""
    big = 1e6
    background = ~mask if valid is None else valid & ~mask
    d = torch.where(background, 0.0, big).to(torch.float32)
    _, h, w = mask.shape

    def sweep(d):
        # pad with `big` so canvas borders never see phantom background
        padded = F.pad(d, (1, 1, 1, 1), value=big)
        cand = d
        # orthogonal cost 3, diagonal cost 4 (Borgefors chamfer 3-4)
        for dy, dx, c in ((1, 0, 3.0), (-1, 0, 3.0), (0, 1, 3.0),
                          (0, -1, 3.0), (1, 1, 4.0), (1, -1, 4.0),
                          (-1, 1, 4.0), (-1, -1, 4.0)):
            window = padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            cand = torch.minimum(cand, window + c)
        return torch.where(background, 0.0, cand)

    done = 0
    while done < iterations:
        for _ in range(min(_CHECK_EVERY, iterations - done)):
            prev, d = d, sweep(d)
            done += 1
        if torch.equal(d, prev):  # the last step changed nothing
            break
    d = torch.where(mask, d, 0.0)
    # Safety clamp: pixels the relaxation never reached still hold the
    # sentinel; cap them at each image's largest relaxed distance
    relaxed = d < big / 2.0
    per_image_max = torch.where(relaxed, d, 0.0).amax(dim=(1, 2),
                                                      keepdim=True)
    d = torch.where(relaxed, d, per_image_max)
    return _true_div(d, 3.0)


# ---------------------------------------------------------------------------
# Batched phase congruency (shape-static filter bank, torch.fft)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _pc_filter_bank(rows: int, cols: int, nscale=4, norient=6, minWaveLength=3,
                    mult=2.1, sigmaOnf=0.55):
    """Precompute the (nscale*norient, rows, cols) log-Gabor*spread bank as
    a float32 NumPy array (a copy of the JAX function, cached per shape)."""
    if cols % 2:
        xvals = np.arange(-(cols - 1) / 2.0, ((cols - 1) / 2.0) + 1) / (cols - 1)
    else:
        xvals = np.arange(-cols / 2.0, cols / 2.0) / cols
    if rows % 2:
        yvals = np.arange(-(rows - 1) / 2.0, ((rows - 1) / 2.0) + 1) / (rows - 1)
    else:
        yvals = np.arange(-rows / 2.0, rows / 2.0) / rows
    x, y = np.meshgrid(xvals, yvals)
    radius = np.fft.ifftshift(np.sqrt(x**2 + y**2))
    theta = np.fft.ifftshift(np.arctan2(-y, x))
    radius[0, 0] = 1.0
    lp = np.fft.ifftshift(1.0 / (1.0 + (np.sqrt(x**2 + y**2) / 0.45) ** 30))
    gabors = []
    for s in range(nscale):
        fo = 1.0 / (minWaveLength * mult**s)
        lg = np.exp(-(np.log(radius / fo)) ** 2 / (2 * np.log(sigmaOnf) ** 2))
        lg *= lp
        lg[0, 0] = 0.0
        gabors.append(lg)
    spreads = []
    for o in range(norient):
        angl = o * np.pi / norient
        ds = np.sin(theta) * np.cos(angl) - np.cos(theta) * np.sin(angl)
        dc = np.cos(theta) * np.cos(angl) + np.sin(theta) * np.sin(angl)
        dtheta = np.minimum(np.abs(np.arctan2(ds, dc)) * norient / 2.0, np.pi)
        spreads.append((np.cos(dtheta) + 1) / 2.0)
    bank = np.stack([g * sp for sp in spreads for g in gabors])  # (O*S, H, W)
    bank = bank.astype(np.float32)
    bank.setflags(write=False)
    return bank


@functools.lru_cache(maxsize=128)
def _device_bank(rows: int, cols: int, device: torch.device, nscale: int,
                 norient: int, mult: float) -> torch.Tensor:
    """The filter bank as a (norient, nscale, rows, cols) tensor, uploaded
    once per shape and device."""
    host = _pc_filter_bank(rows, cols, nscale=nscale, norient=norient,
                           mult=mult)
    return torch.from_numpy(host.copy()).to(device).reshape(
        norient, nscale, rows, cols)


def _masked_median(values, valid):
    """Per-image median over the valid region. values/valid: (B, H, W).

    The two central order statistics of a sort, averaged; invalid pixels
    count as +inf, so an all-invalid image returns inf (as in JAX)."""
    b = values.shape[0]
    flat = torch.where(valid, values, torch.inf).reshape(b, -1)
    n = valid.reshape(b, -1).sum(dim=1)
    ks = torch.stack([torch.clamp((n - 1) // 2, min=0),
                      torch.clamp(n // 2, min=0)], dim=1)
    ordered, _ = torch.sort(flat, dim=1)
    vals = torch.gather(ordered, 1, ks)
    return (vals[:, 0] + vals[:, 1]) / 2.0


def phasecong_Mm_batched(x, valid, nscale=4, norient=6, mult=2.1,
                         k=2.0, cutOff=0.5, g=10.0):
    """Batched ``M + m`` phase congruency of (B, H, W) float images (the
    median noise estimate taken over the valid region).

    Orientations run one after another, so one orientation's (B, S, H, W)
    complex64 responses are alive at a time (a sixth of the stacked set)."""
    b, rows, cols = x.shape
    bank = _device_bank(rows, cols, x.device, nscale, norient, mult)
    # subtract the per-image mean before the transform: the log-Gabor bank
    # zeroes the DC bin anyway, and removing the large DC term keeps the
    # float32 rounding error small
    x = x - x.mean(dim=(1, 2), keepdim=True)
    IM = torch.fft.fft2(x.to(torch.complex64))  # (B, H, W)
    epsilon = 1e-4
    # noise-threshold constants (Rayleigh median -> scale estimate)
    tau_div = float(np.sqrt(np.log(4)))
    tau_geo = float((1 - (1 / mult) ** nscale) / (1 - (1 / mult)))
    tau_mix = float(np.sqrt(np.pi / 2) + k * np.sqrt((4 - np.pi) / 2))
    angles = np.arange(norient) * np.pi / norient
    covx2 = torch.zeros((b, rows, cols), dtype=torch.float32, device=x.device)
    covy2 = torch.zeros_like(covx2)
    for o in range(norient):
        eo = torch.fft.ifft2(IM[:, None] * bank[o][None])  # (B, S, H, W)
        e, o_ = eo.real, eo.imag
        an = torch.sqrt(e * e + o_ * o_)
        sumAn = an.sum(dim=1)                    # (B, H, W)
        sumE = e.sum(dim=1)
        sumO = o_.sum(dim=1)
        x_energy = torch.sqrt(sumE**2 + sumO**2) + epsilon
        mean_e = sumE / x_energy
        mean_o = sumO / x_energy
        energy = (e * mean_e[:, None] + o_ * mean_o[:, None]
                  - torch.abs(e * mean_o[:, None] - o_ * mean_e[:, None])
                  ).sum(dim=1)
        del eo, e, o_
        # noise threshold from the smallest-scale amplitude
        tau = _true_div(_masked_median(an[:, 0], valid), tau_div)
        noise_t = tau * tau_geo * tau_mix        # (B,)
        energy = torch.clamp(energy - noise_t[:, None, None], min=0.0)
        maxAn = an.amax(dim=1)
        del an
        width = _true_div(sumAn / (maxAn + epsilon) - 1, nscale - 1)
        weight = 1.0 / (1 + torch.exp(g * (cutOff - width)))
        pc = weight * energy / sumAn             # (B, H, W)
        angl = torch.tensor(angles[o], dtype=torch.float32, device=x.device)
        covx2 = covx2 + (pc * torch.cos(angl)) ** 2
        covy2 = covy2 + (pc * torch.sin(angl)) ** 2
    return _true_div(covx2 + covy2, norient / 2.0)  # == M + m


def moments_features(mask):
    """(area, major, minor) from masked moment sums; MATLAB regionprops
    ellipse-of-equal-second-moments with the +1/12 pixel term."""
    _, h, w = mask.shape
    m = mask.to(torch.float32)
    ys = torch.arange(h, dtype=torch.float32, device=mask.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=mask.device)[None, None, :]
    n = m.sum(dim=(1, 2))
    safe_n = torch.clamp(n, min=1.0)
    xbar = (m * xs).sum(dim=(1, 2)) / safe_n
    ybar = (m * ys).sum(dim=(1, 2)) / safe_n
    dx = xs - xbar[:, None, None]
    dy = ys - ybar[:, None, None]
    uxx = (m * dx * dx).sum(dim=(1, 2)) / safe_n + 1.0 / 12.0
    uyy = (m * dy * dy).sum(dim=(1, 2)) / safe_n + 1.0 / 12.0
    uxy = (m * dx * dy).sum(dim=(1, 2)) / safe_n
    common = torch.sqrt((uxx - uyy) ** 2 + 4.0 * uxy * uxy)
    major = 2.0 * np.sqrt(2.0) * torch.sqrt(uxx + uyy + common)
    minor = 2.0 * np.sqrt(2.0) * torch.sqrt(
        torch.clamp(uxx + uyy - common, min=0.0))
    empty = n < 0.5
    return (n, torch.where(empty, 0.0, major), torch.where(empty, 0.0, minor))


def _largest_blob(mask, d, iterations: int, candidates: int = 4):
    """Largest-area blob via candidate floods: flood from the deepest
    (max-distance) unclaimed pixel, remove the claimed blob, repeat
    ``candidates`` times, keep the flood with the largest area (the first
    maximum of ``d`` seeds a round, as ``jnp.argmax`` picks it)."""
    b, h, w = mask.shape
    remaining = mask
    best = torch.zeros_like(mask)
    best_area = torch.zeros(b, dtype=torch.int64, device=mask.device)
    for _ in range(candidates):
        flat = torch.where(remaining, d, -1.0).reshape(b, -1)
        peak = torch.argmax(flat, dim=1)
        seed = torch.zeros((b, h * w), dtype=torch.bool, device=mask.device)
        seed[torch.arange(b, device=mask.device), peak] = True
        blob = _flood(seed.reshape(b, h, w) & remaining, remaining,
                      iterations)
        area = blob.sum(dim=(1, 2))
        take = area > best_area
        best = torch.where(take[:, None, None], blob, best)
        best_area = torch.where(take, area, best_area)
        remaining = remaining & ~blob
    return best


def _sum3(x):
    """3x3 box sum of a (B, H, W) float array (zero padding), added in
    window row-major order."""
    _, h, w = x.shape
    padded = F.pad(x, (1, 1, 1, 1))
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + padded[:, dy:dy + h, dx:dx + w]
    return out


def _replicate_fill(x, valid, iterations: int):
    """Fill invalid (slot padding) pixels by propagating the nearest valid
    values outward (mean of already-filled 3x3 neighbors), like an
    edge-replicate pad for a per-image dynamic window (the JAX docstring
    says why a constant fill is catastrophic for phase congruency)."""
    filled = valid.to(torch.float32)
    vals = x * filled
    done = 0
    while done < iterations:
        for _ in range(min(_CHECK_EVERY, iterations - done)):
            cnt = _sum3(filled)
            avg = torch.where(cnt > 0,
                              _sum3(vals) / torch.clamp(cnt, min=1.0), 0.0)
            new_filled = torch.clamp(_dilate3(filled), max=1.0)
            vals = torch.where(filled > 0.5, vals, avg * new_filled)
            filled = new_filled
            done += 1
        if bool((filled > 0.5).all()):
            break
    return vals


def device_features(canvas, heights, widths, fill_iters: int | None = None,
                    edt_iters: int | None = None):
    """(B, 4) float32 ``[area, biovolume_px, major, minor]`` for a packed
    uint8 canvas batch ``(B, ch, cw)`` with int ``heights``/``widths``
    ``(B,)``, all on one device. Flood and chamfer caps default to
    ``ch * cw``, an absolute bound on any geodesic path."""
    _, ch, cw = canvas.shape
    if fill_iters is None:
        fill_iters = ch * cw
    if edt_iters is None:
        edt_iters = ch * cw
    t, valid = batched_otsu(canvas, heights, widths)

    # FFT input: valid pixels, slot padding filled by replicating the
    # nearest border values outward
    xf = canvas.to(torch.float32)
    xfill = _replicate_fill(xf, valid, max(ch, cw))

    mm = phasecong_Mm_batched(xfill, valid)
    weak = (mm > HYST_LOW) & valid
    strong = (mm > HYST_HIGH) & valid
    edges = _flood(strong, weak, fill_iters)

    mask = dilate_disk2(edges, valid)
    mask = fill_holes(mask, valid, fill_iters)
    mask = erode_disk2(mask, valid, 2)
    dark = (canvas.to(torch.int32)
            <= (t.to(torch.float32) * DARK_OTSU_SCALE)[:, None, None]) & valid
    mask = fill_holes(mask | dark, valid, fill_iters)

    d_all = chamfer_distance(mask, edt_iters, valid=valid)
    blob = _largest_blob(mask, d_all, fill_iters)
    d = chamfer_distance(blob, edt_iters, valid=valid)
    area, major, minor = moments_features(blob)
    biovolume = 4.0 * d.sum(dim=(1, 2)) - 3.0 * area
    # one stacked tensor: one device-to-host copy for the whole batch
    return torch.stack([area, biovolume, major, minor], dim=1)
