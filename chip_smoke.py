#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sykepic_tpu_torch``) on one NVIDIA
card: the ``prob`` main path and the fused ``pipeline --device-features``
path at full width, and every kernel on them held against its plain PyTorch
version.

Run from the root of a checkout, on a machine with a card::

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build seconds of ``csrc/*.cu`` (nvcc, one process per
   source, all started together, into ``build/kernels/``) and of the native
   host library.
2. ``kernel_resize_pad``: K1 against its plain version at the main path's
   shapes (the first shelf dispatch of the workload, a crafted shelf
   dispatch, slot canvases of 64x128 and one of 512x512), in float32
   (max |diff| <= 1e-3/255) and bfloat16 (within one bf16 ulp of the plain
   version cast to bf16). Kernel ms are the median of 20 launches timed
   with CUDA events, beside the plain version's ms and the least time the
   card could take (bytes over the memory rate, operations over the float32
   rate).
3. ``prob``: a full-width ResNet18 model dir (the repo's config, seeded
   random weights saved as a reference-layout ``best_state.pth``) and a
   workload of the fixture sample plus 20,000 synthetic ROIs in
   ``bench.py``'s size mix, written as genuine ``.adc/.roi/.hdr`` triplets,
   go through ``python -m sykepic_tpu_torch prob``'s ``main`` with
   ``-b 2048``: shelf packing with the wire codec on (the defaults), again
   warm, with the codec off, and with slot packing. Every CSV is checked,
   and K1's launch count must equal the number of dispatches. A subset runs
   on the CPU and on the card in float32 (same argmax, |dp| <= 1.2e-5) and
   bfloat16 (argmax agreement printed). ``onchip_rate`` in float32 and
   bfloat16, and the e2e runs in bfloat16 through the same `prob` code.
4. ``profile``: a warm float32 stream under ``torch.profiler``: device
   time by kernel, K1's share of it, and the device's busy share.
5. ``kernel_flood``: K2 against its plain version, exact (bool masks and
   step counts), on the seven flood inputs of the first fused dispatch of
   the workload (taken by running the port's feature program on that
   canvas), the seven of the dispatch with the largest canvas that picks
   the shared-memory form (the 4-words-a-thread instance at 256x512),
   random masks at 2048x48x96 with border seeds (picked by size:
   the warp form; then the shared-memory form forced on the same input),
   caps 0 (the load/store floor), 1, 2 and 5, the ring hole-fill, a
   2x200x300 canvas past the warp form (the shared-memory form), a
   2x1024x1400 canvas past the shared-memory budget (the global form), and
   the global form forced at 64x48x96. Each case prints its form, ms
   (median of 20 CUDA-event launches), device ms (torch.profiler), host us
   a call (the wall time of 100 back-to-back calls / 100), steps, the plain
   ms and the bound: the larger of the byte time (seed + within + output,
   3 B a pixel, at 3.35 TB/s) and the operation time (the steps these
   inputs need x 32-pixel words x 12 logic operations a word, whatever
   the form, at the card's int32 rate).
6. ``pipeline``: the same workload through ``python -m sykepic_tpu_torch
   pipeline ... -b 2048 --device-features`` (float32, codec on), cold and
   warm. Every ``.prob.csv`` and ``.feat.csv`` is checked; K1's launches
   must equal the fused dispatches, and K2's warp-form and shared-memory
   launches 7x the dispatches whose canvas picks that form. Then the fused
   on-chip rate, peak device memory, and a warm stream under
   ``torch.profiler`` (K2's device time split by form).
7. ``pipeline_card_vs_cpu``: the fused pass on the 202-ROI comparison set,
   the port on the CPU against the card: probabilities within 1.2e-5, and
   over the ROIs with area >= 50 at least 90% with area, major and minor
   identical (area equal, axes within 1e-5 relative).

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a card, or outside a checkout, the script exits non-zero at once.
Everything it writes goes to ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
FIXTURE = REPO / "tests/data/raw/valid/D20180712T065600_IFCB114"
MODEL_SRC = REPO / "tests/model/resnet18_ref"

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores. K1 is a gather with a few float ops per pixel.
MEMORY_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_PIXEL = 10  # 6 mul/add of the two-tap blends, 3 index ops, /255
# int32 logic: 64 INT32 lanes an SM (half the 128 float32 lanes), 132 SMs,
# 1.98 GHz boost -- a quarter of the float32 figure, which counts an FMA as
# two operations.
INT32_OPS_PER_S = 16.7e12
# K2's logic operations a step for each 32-bit word of 32 pixels: 2 ORs with
# the words above and below, 4 shifts and 4 ORs across the row, 1 AND with
# `within` and 1 compare with the old word. The least work a step can be,
# so the bound is the same for every form.
K2_OPS_PER_WORD = 12
HOST_CALLS = 100  # back-to-back calls whose wall time gives host us a call

N_ROIS = 20_000
PER_SAMPLE = 500
BATCH = 2048  # bench.py:83
N_COMPARE = 200  # ROIs of the CPU-versus-card comparison, plus the fixture
TIMED_LAUNCHES = 20
TIMED_PLAIN = 5
PROB_BOUND = 1.2e-5  # one 1e-5 quantum of the fixed-point rows

# bench.py:114-122, mirrored: (weight, (h_lo, h_hi), (w_lo, w_hi)); 1% of
# ROIs are wider than the 180 px input, so the host pre-shrink runs
ROI_SIZE_MIX = (
    (0.45, (24, 32), (40, 64)),
    (0.22, (33, 48), (40, 64)),
    (0.10, (49, 64), (40, 64)),
    (0.10, (49, 64), (65, 128)),
    (0.08, (65, 128), (65, 128)),
    (0.04, (65, 128), (129, 256)),
    (0.01, (129, 256), (257, 512)),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


# -- workload and model -------------------------------------------------------

def roi_shapes(rng, n):
    weights = np.array([m[0] for m in ROI_SIZE_MIX])
    picks = rng.choice(len(ROI_SIZE_MIX), size=n, p=weights / weights.sum())
    return [(int(rng.integers(ROI_SIZE_MIX[k][1][0], ROI_SIZE_MIX[k][1][1] + 1)),
             int(rng.integers(ROI_SIZE_MIX[k][2][0], ROI_SIZE_MIX[k][2][1] + 1)))
            for k in picks]


def fixture_images():
    from sykepic_tpu_torch.ingest import ifcb

    return [img for _, img in ifcb.read_sample(FIXTURE).images()]


def resampled(rng, images, h, w):
    """A fixture ROI resampled (nearest) to (h, w), with seeded noise."""
    src = images[int(rng.integers(len(images)))]
    ys = (np.arange(h) * src.shape[0] // h).clip(0, src.shape[0] - 1)
    xs = (np.arange(w) * src.shape[1] // w).clip(0, src.shape[1] - 1)
    noise = rng.integers(-3, 4, (h, w))
    return np.clip(src[np.ix_(ys, xs)].astype(np.int16) + noise, 0,
                   255).astype(np.uint8)


def write_sample(raw_dir: Path, name: str, imgs) -> Path:
    """One genuine .adc/.roi/.hdr triplet (cols 15/16/17 = width/height/
    start byte); returns the suffix-less sample path."""
    rows, payload, start = [], bytearray(), 0
    for img in imgs:
        h, w = img.shape
        cols = ["0"] * 24
        cols[15], cols[16], cols[17] = str(w), str(h), str(start)
        rows.append(",".join(cols))
        payload.extend(img.tobytes())
        start += h * w
    (raw_dir / f"{name}.adc").write_text("\n".join(rows) + "\n")
    (raw_dir / f"{name}.roi").write_bytes(bytes(payload))
    (raw_dir / f"{name}.hdr").write_text("runTime: 1200\ninhibitTime: 18\n")
    return raw_dir / name


def build_raw(raw_dir: Path, n_rois: int, seed: int, start: datetime):
    """The fixture sample plus ``n_rois`` synthetic ROIs in samples of
    ``PER_SAMPLE``; returns ``{sample path: number of ROIs}``."""
    raw_dir.mkdir(parents=True)
    for suffix in (".adc", ".roi", ".hdr"):
        shutil.copy(FIXTURE.with_suffix(suffix), raw_dir)
    images = fixture_images()
    rng = np.random.default_rng(seed)
    counts = {raw_dir / FIXTURE.name: len(images)}
    for s in range(-(-n_rois // PER_SAMPLE)):
        n = min(PER_SAMPLE, n_rois - s * PER_SAMPLE)
        name = f"D{start + timedelta(minutes=s):%Y%m%dT%H%M%S}_IFCB114"
        imgs = [resampled(rng, images, h, w) for h, w in roi_shapes(rng, n)]
        counts[write_sample(raw_dir, name, imgs)] = n
    return counts


def build_model_dir(root: Path) -> Path:
    """The repo's full-width ResNet18 config with weights drawn from a
    seeded torch.Generator, saved in the reference ``base.N``/``head.K``
    layout."""
    from sykepic_tpu_torch.models import checkpoint
    from sykepic_tpu_torch.train import config as tcfg

    d = root / "model"
    d.mkdir(parents=True)
    for f in ("config.ini", "class_names.txt"):
        shutil.copy(MODEL_SRC / f, d / f)
    model, _ = tcfg.get_network(tcfg.read_config(d / "config.ini"),
                                len(checkpoint.read_class_names(d)))
    g = torch.Generator().manual_seed(0)
    base_index = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
                  "layer3": "6", "layer4": "7"}
    sd = {}
    for key, v in model.state_dict().items():
        def rnd():
            return torch.randn(v.shape, generator=g)
        if key.endswith("num_batches_tracked"):
            new = v
        elif key.startswith("head."):
            fan_in = v.shape[-1] if v.dim() == 2 else 1
            new = rnd() * (fan_in ** -0.5 if v.dim() == 2 else 0.01)
        elif v.dim() == 4:  # conv (O, I, kH, kW): He-normal
            new = rnd() * (2.0 / v[0].numel()) ** 0.5
        elif key.endswith("running_mean"):
            new = rnd() * 0.05
        elif key.endswith("running_var"):
            new = 0.75 + 0.5 * torch.rand(v.shape, generator=g)
        elif key.endswith("weight"):  # BatchNorm gamma
            new = 1.0 + 0.1 * rnd()
        else:  # BatchNorm beta
            new = 0.05 * rnd()
        head, _, rest = key.partition(".")
        sd[key if head == "head" else f"base.{base_index[head]}.{rest}"] = new
    torch.save(sd, d / checkpoint.TORCH_STATE)
    return d


def sample_blocks(paths):
    from sykepic_tpu_torch.ingest import ifcb, pack

    for idx, p in enumerate(paths):
        rois = ifcb.read_sample(p)
        yield pack.RoiBlock(sample_idx=idx, roi_ids=rois.roi_ids,
                            heights=rois.heights, widths=rois.widths,
                            offsets=rois.starts, base=rois.roi_data)


def count_dispatches(paths, packing: str) -> int:
    """Dispatches the engine makes for these samples with ``-b BATCH``:
    the same packing pass, counted on the host."""
    from sykepic_tpu_torch.ingest import pack, shelf

    if packing == "shelf":
        gen = shelf.pack_shelves(sample_blocks(paths), pre_shrink_to=(180, 180),
                                 slot_cap=min(shelf.SLOT_CAP, max(BATCH, 1024)))
    else:
        gen = pack.pack_rois(pack.roi_items(sample_blocks(paths)),
                             batch_size=BATCH, buckets=None,
                             pre_shrink_to=(180, 180))
    return sum(1 for _ in gen)


# -- phases -------------------------------------------------------------------

def phase_env(smi: str) -> dict:
    from sykepic_tpu_torch.ingest import native
    from sykepic_tpu_torch.ops import cuda_build

    native_s = {}

    def build_native():
        t0 = time.perf_counter()
        native_s["lib"] = native.lib()
        native_s["s"] = time.perf_counter() - t0

    th = threading.Thread(target=build_native)
    th.start()
    kernel_s = cuda_build.build_all()
    th.join()
    check(native_s["lib"] is not None, "the native host library did not build")
    out = {"phase": "env", "gpu": smi, "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0], "build_s": kernel_s,
           "native_build_s": native_s["s"]}
    emit(out)
    return out


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` calls, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, word: str, reps: int) -> float:
    """Device time a call of ``fn`` spends in kernels whose name holds
    ``word``, from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if word in e.key) / 1e3 / reps


def k1_case(name, pixels: np.ndarray, meta: np.ndarray, target=180) -> dict:
    """K1 against its plain version on one input, both dtypes."""
    from sykepic_tpu_torch.ops import preprocess, resize_pad

    dev = torch.device("cuda")
    pix = torch.from_numpy(pixels).to(dev)
    m = torch.from_numpy(meta).to(dev)
    r = meta.shape[1]
    h, w, nh, nw = (meta[i].astype(np.int64) for i in (3, 4, 5, 6))
    read = min(int((h * w).sum()), pixels.size) + meta.nbytes
    inside = int((nh * nw).sum())
    out = {"phase": "kernel_resize_pad", "case": name,
           "pixels": list(pixels.shape), "slots": r}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        before = resize_pad.launches
        got = resize_pad.resize_pad(pix, m, target, target, 3, dtype)
        torch.cuda.synchronize()
        check(resize_pad.launches == before + 1, "K1 did not launch")
        plain = preprocess.resize_pad_plain(pix, m, target, target, 3,
                                            torch.float32)
        check(got.shape == plain.shape and got.dtype == dtype,
              f"K1 {name}: {tuple(got.shape)} {got.dtype}")
        err = (got.float() - plain.to(dtype).float()).abs()
        if dtype == torch.float32:
            check(float(err.max()) <= 1e-3 / 255,
                  f"K1 {name} f32: max |diff| {float(err.max())}")
        else:  # one bf16 ulp of the plain version cast to bf16
            ulp = plain.to(dtype).float().abs() * 2.0 ** -7
            check(bool((err <= ulp).all()), f"K1 {name} bf16: beyond 1 ulp")
        written = got.numel() * got.element_size()
        bytes_s = (read + written) / MEMORY_BYTES_PER_S
        ops_s = inside * 3 * K1_OPS_PER_PIXEL / F32_OPS_PER_S
        out[tag] = {
            "max_abs_err": float(err.max()),
            "ms": time_ms(lambda: resize_pad.resize_pad(
                pix, m, target, target, 3, dtype), TIMED_LAUNCHES),
            "plain_ms": time_ms(lambda: preprocess.resize_pad_plain(
                pix, m, target, target, 3, dtype), TIMED_PLAIN),
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bytes": read + written,
        }
    out["launches"] = resize_pad.launches
    emit(out)
    return out


def phase_kernel(model_dir: Path, samples) -> dict:
    """K1 at the main path's shapes; returns the main-path case."""
    from sykepic_tpu_torch.compute.engine import Classifier
    from sykepic_tpu_torch.ingest import shelf
    from sykepic_tpu_torch.ops import preprocess

    clf = Classifier(model_dir, batch_size=BATCH)  # host metadata only
    first = next(shelf.pack_shelves(
        sample_blocks(samples), pre_shrink_to=(180, 180), compute_modes=True,
        slot_cap=clf._shelf_slot_cap))
    main_case = k1_case("shelf_first_dispatch", first.windows,
                        clf._shelf_meta(first))

    rng = np.random.default_rng(1)
    images = fixture_images()
    nc, r = 8, 1024
    windows = rng.integers(0, 30, (nc, shelf.WIN_H, shelf.WIN_W),
                           dtype=np.uint8)
    hw = np.array([(min(h, 180), min(w, 180)) for h, w in roi_shapes(rng, r)])
    win = rng.integers(0, nc, r)
    y0 = (rng.random(r) * (shelf.WIN_H - hw[:, 0])).astype(np.int32)
    x0 = (rng.random(r) * (shelf.WIN_W - hw[:, 1])).astype(np.int32)
    for i in range(r):
        windows[win[i], y0[i]:y0[i] + hw[i, 0], x0[i]:x0[i] + hw[i, 1]] = \
            resampled(rng, images, *hw[i])
    geom = preprocess.compute_geometry(hw[:, 0], hw[:, 1], 180, 180)
    border = rng.integers(0, 256, r)
    k1_case("shelf_8x1024", windows, preprocess.slot_meta(
        hw[:, 0], hw[:, 1], *geom, border, win, y0, x0))

    for b, ch, cw in ((256, 64, 128), (1, 512, 512)):
        hs = rng.integers(1, ch + 1, b)
        ws = rng.integers(1, cw + 1, b)
        canvas = np.zeros((b, ch, cw), np.uint8)
        for i in range(b):
            canvas[i, :hs[i], :ws[i]] = resampled(rng, images, hs[i], ws[i])
        geom = preprocess.compute_geometry(hs, ws, 180, 180)
        border = preprocess.border_values(canvas, hs, ws, "mode")
        k1_case(f"slots_{b}x{ch}x{cw}", canvas,
                preprocess.slot_meta(hs, ws, *geom, border))
    return main_case


def check_csvs(out_dir: Path, counts: dict, classes) -> None:
    from sykepic_tpu_torch.utils import files

    header = "roi," + ",".join(classes)
    for sample, n in counts.items():
        path = files.sample_csv_path(sample, out_dir, ".prob")
        lines = path.read_text().splitlines()
        check(lines[0] == header, f"{path.name}: header")
        check(len(lines) == n + 1, f"{path.name}: {len(lines) - 1} rows != {n}")
        rows = np.array([[float(v) for v in line.split(",")]
                         for line in lines[1:]])
        probs = rows[:, 1:]
        check(np.isfinite(probs).all() and (probs >= 0).all(),
              f"{path.name}: non-finite or negative probabilities")
        check(np.abs(probs.sum(1) - 1.0).max() <= 1e-3,
              f"{path.name}: rows do not sum to 1")
        check((np.diff(rows[:, 0]) > 0).all(), f"{path.name}: not roi-sorted")


def timed_run(fn, env: dict) -> tuple[float, int]:
    """``fn()`` under ``env``; returns (seconds, K1 launches). The launch
    count starts from 0 for this run."""
    from sykepic_tpu_torch.ops import resize_pad

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        resize_pad.launches = 0
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, resize_pad.launches
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def classify(clf, paths):
    """(sample idx, roi id) -> probability row, through classify_rois."""
    from sykepic_tpu_torch.ingest import ifcb

    tagged = [(s, rid, img) for s, p in enumerate(paths)
              for rid, img in ifcb.read_sample(p).images()]
    return {(s, r): p for s, r, p in clf.classify_rois(tagged)}


def phase_prob(model_dir: Path, raw: Path, counts: dict) -> int:
    """The main path through the CLI; returns K1's launches in the first
    (default) run."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.compute import probability
    from sykepic_tpu_torch.compute.engine import Classifier
    from sykepic_tpu_torch.models import checkpoint

    classes = checkpoint.read_class_names(model_dir)
    n_rois = sum(counts.values())
    samples = list(counts)
    runs = {}

    def cli(out, force):
        # python -m sykepic_tpu_torch prob, in-process, on the card
        main(["prob", "-r", str(raw), "-m", str(model_dir), "-o", str(out),
              "-b", str(BATCH)] + (["-f"] if force else []))

    def bf16(out):
        # the CLI has no dtype option: the same entry point, a bf16 model
        probability.main(samples, model_dir, out, BATCH, force=True,
                         progress_bar=False, classifier=Classifier(
                             model_dir, batch_size=BATCH, dtype="bfloat16"))

    shelf_out, slots_out = WORK / "out_shelf", WORK / "out_slots"
    for name, env, fn in (
            ("shelf_codec_on", {}, lambda: cli(shelf_out, False)),
            ("shelf_codec_on_warm", {}, lambda: cli(shelf_out, True)),
            ("shelf_codec_off", {"SYKEPIC_WIRE_CODEC": "off"},
             lambda: cli(shelf_out, True)),
            ("slots_codec_on", {"SYKEPIC_PACKING": "slots"},
             lambda: cli(slots_out, False)),
            ("shelf_bf16_codec_on", {}, lambda: bf16(shelf_out)),
            ("shelf_bf16_codec_off", {"SYKEPIC_WIRE_CODEC": "off"},
             lambda: bf16(shelf_out))):
        seconds, launches = timed_run(fn, env)
        packing = env.get("SYKEPIC_PACKING", "shelf")
        dispatches = count_dispatches(samples, packing)
        check_csvs(slots_out if packing == "slots" else shelf_out, counts,
                   classes)
        check(launches == dispatches,
              f"{name}: K1 launched {launches} times for {dispatches} dispatches")
        runs[name] = {"seconds": seconds, "rois_per_s": n_rois / seconds,
                      "dispatches": dispatches, "k1_launches": launches}
    emit({"phase": "prob", "rois": n_rois, "samples": len(samples),
          "batch": BATCH, "runs": runs})

    # the port on the CPU and on the card, the same ROIs
    small_raw = WORK / "raw_compare"
    small = list(build_raw(small_raw, N_COMPARE, seed=7,
                           start=datetime(2019, 1, 1)))
    cpu = classify(Classifier(model_dir, batch_size=BATCH, device="cpu"),
                   small)
    f32 = classify(Classifier(model_dir, batch_size=BATCH), small)
    bf16 = classify(Classifier(model_dir, batch_size=BATCH,
                               dtype="bfloat16"), small)
    check(cpu.keys() == f32.keys() == bf16.keys(), "ROI sets differ")
    keys = sorted(cpu)
    pc = np.stack([cpu[k] for k in keys])
    pg = np.stack([f32[k] for k in keys])
    pb = np.stack([bf16[k] for k in keys])
    top2 = np.sort(pc, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * PROB_BOUND  # not a tie
    diff = float(np.abs(pc - pg).max())
    check(diff <= PROB_BOUND, f"card vs CPU f32: max |dp| {diff}")
    check((pc.argmax(1) == pg.argmax(1))[clear].all(),
          "card vs CPU f32: argmax differs")
    emit({"phase": "prob_card_vs_cpu", "rois": len(keys),
          "f32_max_abs_dp": diff,
          "f32_argmax_agree": float((pc.argmax(1) == pg.argmax(1)).mean()),
          "ties_within_two_quanta": int((~clear).sum()),
          "bf16_argmax_agree_with_f32": float(
              (pb.argmax(1) == pg.argmax(1)).mean()),
          "bf16_max_abs_dp": float(np.abs(pb - pg).max()),
          "mean_top_prob": float(pg.max(1).mean())})

    rates = {}
    for dtype in ("float32", "bfloat16"):
        clf = Classifier(model_dir, batch_size=BATCH, dtype=dtype)
        n, seconds = clf.onchip_rate(sample_blocks(samples))
        rates[dtype] = {"rois": n, "seconds_per_pass": seconds,
                        "rois_per_s": n / seconds}
    emit({"phase": "onchip_rate", "packing": "shelf", **rates})
    return runs["shelf_codec_on"]["k1_launches"]


def phase_profile(model_dir: Path, samples) -> None:
    """Where the device time of a warm float32 stream goes: CUDA kernel
    time by name under torch.profiler, K1's share, and the device's busy
    share of the wall clock (the profiler slows the host side)."""
    from sykepic_tpu_torch.compute.engine import Classifier

    clf = Classifier(model_dir, batch_size=BATCH)

    def stream():
        for _ in clf.classify_blocks(sample_blocks(samples)):
            pass

    stream()  # warm
    torch.cuda.synchronize()
    emit({"phase": "profile", **device_profile(stream)})


def fused_dispatch(model_dir: Path, samples, shape=None):
    """The first (batch, meta) of the fused stream over ``samples`` (the
    first whose canvas is ``shape`` (h, w), when given), as
    ``classify_and_feature_rois`` packs it with ``-b BATCH``."""
    from sykepic_tpu_torch.compute.engine import Classifier

    gen = Classifier(model_dir, batch_size=BATCH)._prepared_fused(
        sample_blocks(samples))
    try:
        for batch, meta in gen:
            if shape is None or tuple(batch.canvas.shape[1:]) == shape:
                return batch, meta
    finally:
        gen.close()
    raise AssertionError(f"no fused dispatch has a {shape} canvas")


def capture_floods(canvas, heights, widths):
    """The (seed, within, cap) of each flood the feature program runs on
    one canvas batch, in order: its own steps, recorded at ``_flood``."""
    from sykepic_tpu_torch.ops import features_device as fd

    calls = []
    original = fd._flood

    def record(seed, within, iterations):
        calls.append((seed.contiguous().clone(), within.contiguous().clone(),
                      int(iterations)))
        return original(seed, within, iterations)

    fd._flood = record
    try:
        with torch.inference_mode():
            fd.device_features(canvas, heights, widths)
    finally:
        fd._flood = original
    return calls


FLOOD_COUNTERS = {"warp": "warp_launches", "shared": "launches",
                  "global": "global_launches"}


def flood_counts() -> dict:
    from sykepic_tpu_torch.ops import flood

    return {form: getattr(flood, c) for form, c in FLOOD_COUNTERS.items()}


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host time of one call: the wall time of ``calls`` back-to-back calls
    (no synchronisation between them) over ``calls``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * wall / calls


def k2_case(name, seed, within, cap, form=None) -> dict:
    """K2 against its plain version on one input: exact masks and steps."""
    from sykepic_tpu_torch.ops import flood

    b, h, w = seed.shape
    before = flood_counts()
    got, steps = flood.flood(seed, within, cap, return_steps=True, form=form)
    torch.cuda.synchronize()
    ran = [f for f, n in flood_counts().items() if n > before[f]]
    check(len(ran) == 1, f"K2 {name}: launched the forms {ran}")
    used = ran[0]
    check(form is None or used == form, f"K2 {name}: ran the {used} form")
    plain, plain_steps = flood.flood_plain(seed, within, cap,
                                           return_steps=True)
    check(got.dtype == torch.bool and got.shape == seed.shape,
          f"K2 {name}: {got.dtype} {tuple(got.shape)}")
    diff = int((got != plain).sum())
    check(diff == 0, f"K2 {name}: {diff} pixels differ from the plain version")
    check(torch.equal(steps, plain_steps), f"K2 {name}: step counts differ")
    bytes_s = 3 * b * h * w / MEMORY_BYTES_PER_S
    ops_s = (int(steps.to(torch.int64).sum()) * h * -(-w // 32)
             * K2_OPS_PER_WORD / INT32_OPS_PER_S)

    def call():
        return flood.flood(seed, within, cap, form=form)

    out = {"phase": "kernel_flood", "case": name, "shape": [b, h, w],
           "cap": cap, "form": used,
           "instance": flood.pick_form(h, w, flood.smem_limit(seed.device))
           if used == "warp" else used,
           "max_abs_err": float(diff),
           "steps_max": int(steps.max()) if b else 0,
           "steps_mean": float(steps.float().mean()) if b else 0.0,
           "ms": time_ms(call, TIMED_LAUNCHES),
           # the kernels' own device time, without the wrapper's host time
           "device_ms": device_ms(call, "flood_", TIMED_LAUNCHES),
           "host_us": host_us(call),
           "plain_ms": time_ms(lambda: flood.flood_plain(seed, within, cap),
                               TIMED_PLAIN),
           "bytes_ms": 1e3 * bytes_s, "ops_ms": 1e3 * ops_s,
           "bound_ms": 1e3 * max(bytes_s, ops_s),
           "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
    emit(out)
    return out


FLOOD_NAMES = ("hysteresis", "fill_holes_1", "fill_holes_2", "blob_1",
               "blob_2", "blob_3", "blob_4")


def dispatch_floods(model_dir: Path, samples, name, shape=None) -> dict:
    """K2 on the seven floods of one fused dispatch (the first, or the
    first with a ``shape`` canvas), each case exact; prints and returns
    their sums: the main path's K2 work for that dispatch. Its bound is the
    larger of their summed byte time and their summed operation time."""
    dev = torch.device("cuda")
    batch, _ = fused_dispatch(model_dir, samples, shape)
    canvas = torch.from_numpy(batch.canvas).to(dev)
    calls = capture_floods(canvas, torch.from_numpy(batch.heights).to(dev),
                           torch.from_numpy(batch.widths).to(dev))
    check(len(calls) == 7, f"the feature program ran {len(calls)} floods")
    cases = [k2_case(f"{name}_{n}", *call)
             for n, call in zip(FLOOD_NAMES, calls)]
    total = {k: sum(c[k] for c in cases)
             for k in ("ms", "device_ms", "host_us", "plain_ms", "bytes_ms",
                       "ops_ms")}
    total["bound_ms"] = max(total["bytes_ms"], total["ops_ms"])
    total["bound_by"] = ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                         else "operations")
    total["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    total["forms"] = sorted({c["form"] for c in cases})
    emit({"phase": "kernel_flood", "case": f"{name}_all_seven",
          "shape": cases[0]["shape"], **total})
    return total


def phase_flood(model_dir: Path, samples) -> dict:
    """K2 on every case; returns the sums over the seven floods of the
    first fused dispatch (the main path's K2 work for one dispatch)."""
    from sykepic_tpu_torch.ops import flood

    dev = torch.device("cuda")
    first = dispatch_floods(model_dir, samples, "first_dispatch")
    # the shared-memory form as the main path runs it: the dispatch with
    # the most words a canvas among those that pick it
    limit = flood.smem_limit(dev)
    shared = [(h * -(-w // 32), (h, w)) for _, h, w in fused_shapes(samples)
              if flood.pick_form(h, w, limit) == "shared"]
    check(shared, "no fused dispatch picks the shared-memory form")
    big = dispatch_floods(model_dir, samples, "shared_dispatch",
                          max(shared)[1])
    check(big["forms"] == ["shared"],
          f"the shared dispatch ran the forms {big['forms']}")

    rng = np.random.default_rng(3)

    def random_case(b, h, w, p=0.5):
        within = rng.uniform(size=(b, h, w)) < p
        seed = np.zeros_like(within)
        seed[:, 0, :] = within[:, 0, :]  # border seeds, as fill_holes makes
        seed[:, -1, :] = within[:, -1, :]
        seed[:, :, 0] = within[:, :, 0]
        seed[:, :, -1] = within[:, :, -1]
        return (torch.from_numpy(seed).to(dev),
                torch.from_numpy(within).to(dev))

    s, m = random_case(2048, 48, 96)
    warp = k2_case("random_2048x48x96", s, m, 48 * 96)
    check(warp["form"] == "warp", "2048x48x96 did not pick the warp form")
    k2_case("random_2048x48x96_shared", s, m, 48 * 96, form="shared")
    for cap in (0, 1, 2, 5):
        k2_case(f"random_2048x48x96_cap{cap}", s, m, cap)
    yy, xx = np.mgrid[0:40, 0:40]
    r = np.hypot(yy - 20, xx - 20)
    free = ~((r < 15) & (r > 8))[None]
    ring_seed = np.zeros_like(free)
    ring_seed[:, 0, :] = ring_seed[:, -1, :] = True
    ring_seed[:, :, 0] = ring_seed[:, :, -1] = True
    ring = k2_case("ring_1x40x40", torch.from_numpy(ring_seed & free).to(dev),
                   torch.from_numpy(free).to(dev), 1600)
    check(ring["form"] == "warp", f"the ring ran the {ring['form']} form")
    s, m = random_case(2, 200, 300)
    check(k2_case("random_2x200x300", s, m, 200 * 300)["form"] == "shared",
          "200x300 did not pick the shared-memory form")
    s, m = random_case(2, 1024, 1400, p=0.6)
    check(flood.shared_bytes(1024, 1400) > flood.smem_limit(dev),
          "1024x1400 fits shared memory")
    k2_case("random_2x1024x1400", s, m, 1024 * 1400)
    s, m = random_case(64, 48, 96)
    k2_case("random_64x48x96_global", s, m, 48 * 96, form="global")

    return first


def check_feat_csvs(out_dir: Path, counts: dict) -> None:
    from sykepic_tpu_torch.compute import feature_native
    from sykepic_tpu_torch.utils import files

    for sample, n in counts.items():
        path = files.sample_csv_path(sample, out_dir, ".feat")
        lines = path.read_text().splitlines()
        check(lines[0] == "# version=tpu-dev-v1", f"{path.name}: version")
        check(lines[1].startswith("# volume_ml=")
              and float(lines[1].split("=")[1]) > 0, f"{path.name}: volume")
        check(lines[2] == feature_native.CSV_COLUMNS, f"{path.name}: columns")
        check(len(lines) == n + 3, f"{path.name}: {len(lines) - 3} rows != {n}")
        cells = [line.split(",") for line in lines[3:]]
        check(all(c[4].isdigit() for c in cells),
              f"{path.name}: area is not an integer >= 0")
        rows = np.array([[float(v) for v in c] for c in cells])
        check(np.isfinite(rows).all(), f"{path.name}: non-finite features")
        check((np.diff(rows[:, 0]) > 0).all(), f"{path.name}: not roi-sorted")


def fused_shapes(samples):
    """Canvas shapes of the fused stream's dispatches with ``-b BATCH``:
    the same packing pass, counted on the host."""
    from sykepic_tpu_torch.ingest import pack

    return [b.canvas.shape for b in pack.pack_rois(
        pack.roi_items(sample_blocks(samples)), batch_size=BATCH,
        buckets=None, pre_shrink_to=None, consolidate_tails=False)]


def device_profile(run) -> dict:
    """Device time by kernel while ``run()`` goes: CUDA activity only under
    torch.profiler, summed from the raw trace events (the fused stream
    makes hundreds of thousands of kernels; ``key_averages`` would spend
    minutes building its tree of them)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        ms = (e.duration_ns() / 1e6 if hasattr(e, "duration_ns")
              else e.duration_us() / 1e3)
        acc = by_name.setdefault(e.name(), [0.0, 0])
        acc[0] += ms
        acc[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())

    def share(word):
        ms = sum(v[0] for key, v in by_name.items() if word in key)
        return ms, ms / busy_ms if busy_ms else None

    k1_ms, k1_share = share("resize_pad")
    k2_ms, k2_share = share("flood_")
    k2_by_form = {"warp": share("flood_warp")[0],
                  "shared": share("flood_shared")[0],
                  "global": share("flood_step")[0] + share("flood_init")[0]}
    # device time by kind, the first matching word of each kernel's name
    kinds = (("K1", ("resize_pad",)), ("K2", ("flood_",)),
             ("cuFFT", ("fft",)),
             ("cuDNN/cuBLAS", ("xmma", "convolve", "cudnn", "gemm")),
             ("max_pool", ("max_pool",)), ("reduce", ("reduce",)),
             ("sort", ("sort", "radix")), ("elementwise", ("elementwise",)),
             ("copy/fill", ("Memcpy", "Memset", "copy")))
    by_kind = {k: 0.0 for k, _ in kinds + (("other", ()),)}
    for key, (ms, _) in by_name.items():
        kind = next((k for k, words in kinds
                     if any(w in key for w in words)), "other")
        by_kind[kind] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (1e3 * wall) if wall else None,
            "device_events": sum(n for _, n in by_name.values()),
            "k1_ms": k1_ms, "k1_share_of_device": k1_share,
            "k2_ms": k2_ms, "k2_share_of_device": k2_share,
            "k2_ms_by_form": k2_by_form,
            "device_ms_by_kind": by_kind,
            "kernels_seen": len(by_name),
            "top": [{"kernel": key[:80], "ms": v[0], "calls": v[1]}
                    for key, v in top]}


def phase_pipeline(model_dir: Path, raw: Path, counts: dict) -> dict:
    """The fused path through the CLI; returns K1's and K2's launches in
    the first run."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.compute.engine import Classifier
    from sykepic_tpu_torch.models import checkpoint
    from sykepic_tpu_torch.ops import flood, resize_pad

    classes = checkpoint.read_class_names(model_dir)
    samples = list(counts)
    n_rois = sum(counts.values())
    shapes = fused_shapes(samples)
    limit = flood.smem_limit(torch.device("cuda"))
    picks = [flood.pick_form(h, w, limit) for _, h, w in shapes]
    by_form = {f: sum(1 for p in picks if (p if isinstance(p, str)
                                             else p[0]) == f)
               for f in FLOOD_COUNTERS}
    out = WORK / "out_fused"
    runs = {}
    for name, force in (("fused_codec_on", False),
                        ("fused_codec_on_warm", True)):
        resize_pad.launches = 0
        flood.warp_launches = flood.launches = flood.global_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        main(["pipeline", "-r", str(raw), "-m", str(model_dir), "-o",
              str(out), "-b", str(BATCH), "--device-features"]
             + (["-f"] if force else []))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"k1": resize_pad.launches,
                    **{f"k2_{f}": n for f, n in flood_counts().items()}}
        check_csvs(out, counts, classes)
        check_feat_csvs(out, counts)
        check(launches["k1"] == len(shapes),
              f"{name}: K1 launched {launches['k1']} times for "
              f"{len(shapes)} dispatches")
        for f in ("warp", "shared"):
            check(launches[f"k2_{f}"] == 7 * by_form[f],
                  f"{name}: K2's {f} form launched {launches[f'k2_{f}']} "
                  f"times for {by_form[f]} dispatches that pick it")
        check(by_form["global"] > 0 or launches["k2_global"] == 0,
              f"{name}: the global form ran on no canvas that picks it")
        runs[name] = {"seconds": seconds, "rois_per_s": n_rois / seconds,
                      "dispatches": len(shapes),
                      "dispatches_by_k2_form": by_form,
                      "launches": launches,
                      "peak_device_mib": torch.cuda.max_memory_allocated()
                      / 2**20}
    emit({"phase": "pipeline", "rois": n_rois, "samples": len(samples),
          "batch": BATCH, "canvas_shapes": len(set(shapes)), "runs": runs})

    clf = Classifier(model_dir, batch_size=BATCH)
    torch.cuda.reset_peak_memory_stats()
    # every dispatch of the stream resident: the same work as the e2e runs
    n, seconds = clf.fused_onchip_rate(sample_blocks(samples), repeats=1,
                                       max_batches=len(shapes))
    emit({"phase": "pipeline_onchip", "rois": n, "dispatches": len(shapes),
          "seconds_per_pass": seconds, "rois_per_s": n / seconds,
          "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20})
    subset = samples[:11]  # the fixture and 10 x 500 ROIs

    def stream():
        for _ in clf.classify_and_feature_rois(sample_blocks(subset)):
            pass

    stream()  # warm
    torch.cuda.synchronize()
    emit({"phase": "pipeline_profile",
          "profile_rois": sum(counts[s] for s in subset),
          **device_profile(stream)})
    return runs["fused_codec_on"]["launches"]


def fused(clf, paths):
    """(sample idx, roi id) -> (probability row, features), through
    classify_and_feature_rois."""
    from sykepic_tpu_torch.ingest import ifcb

    tagged = [(s, rid, img) for s, p in enumerate(paths)
              for rid, img in ifcb.read_sample(p).images()]
    return {(s, r): (p, np.array(f))
            for s, r, p, f in clf.classify_and_feature_rois(tagged)}


def phase_pipeline_compare(model_dir: Path) -> None:
    """The fused pass on the comparison set: the port on the CPU against
    the port on the card."""
    from sykepic_tpu_torch.compute.engine import Classifier
    from sykepic_tpu_torch.utils import files

    small = files.list_sample_paths(WORK / "raw_compare")
    cpu = fused(Classifier(model_dir, batch_size=BATCH, device="cpu"), small)
    card = fused(Classifier(model_dir, batch_size=BATCH), small)
    check(cpu.keys() == card.keys(), "ROI sets differ")
    keys = sorted(cpu)
    pc = np.stack([cpu[k][0] for k in keys])
    pg = np.stack([card[k][0] for k in keys])
    fc = np.stack([cpu[k][1] for k in keys])  # area, biovolume, major, minor
    fg = np.stack([card[k][1] for k in keys])
    check(np.isfinite(fg).all(), "non-finite features on the card")
    dp = float(np.abs(pc - pg).max())
    check(dp <= PROB_BOUND, f"fused card vs CPU: max |dp| {dp}")
    big = fc[:, 0] >= 50
    c, g = fc[big], fg[big]
    same = ((c[:, 0] == g[:, 0]) & (np.abs(g[:, 2] / c[:, 2] - 1) <= 1e-5)
            & (np.abs(g[:, 3] / c[:, 3] - 1) <= 1e-5))
    rel = np.abs(g / np.where(c == 0, 1, c) - 1)[~same]
    share = float(same.mean()) if len(c) else 1.0
    emit({"phase": "pipeline_card_vs_cpu", "rois": len(keys),
          "max_abs_dp": dp, "rois_area_ge_50": int(big.sum()),
          "identical_share": share,
          "bit_identical_share": float((c == g).all(axis=1).mean())
          if len(c) else 1.0,
          "max_rel_diff_of_the_rest": {
              k: float(rel[:, i].max()) if len(rel) else 0.0
              for i, k in enumerate(("area", "biovolume", "major", "minor"))}})
    check(share >= 0.9, f"only {share:.1%} of ROIs have identical features")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (REPO / "sykepic_tpu_torch").is_dir() or not FIXTURE.with_suffix(
            ".roi").is_file():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if WORK.exists():
        shutil.rmtree(WORK)
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    timed("env", phase_env, smi)
    model_dir = build_model_dir(WORK)
    raw = WORK / "raw"
    counts = timed("workload", build_raw, raw, N_ROIS, 42,
                   datetime(2018, 7, 12))
    main_case = timed("kernel_resize_pad", phase_kernel, model_dir,
                      list(counts))
    launches = timed("prob", phase_prob, model_dir, raw, counts)
    check(launches > 0, "the main path never launched K1")
    timed("profile", phase_profile, model_dir, list(counts))
    k2 = timed("kernel_flood", phase_flood, model_dir, list(counts))
    fused_launches = timed("pipeline", phase_pipeline, model_dir, raw, counts)
    check(fused_launches["k1"] > 0, "the fused path never launched K1")
    k2_launches = {f: fused_launches[f"k2_{f}"] for f in FLOOD_COUNTERS}
    check(sum(k2_launches.values()) > 0, "the fused path never launched K2")
    check(k2_launches["warp"] > 0, "the fused path never launched K2's warp "
          "form")
    timed("pipeline_card_vs_cpu", phase_pipeline_compare, model_dir)
    emit({"phase_seconds": seconds})
    k = main_case["f32"]
    emit({"kernels": [{
        "name": "resize_pad",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/resize_pad.cu",
        "replaces": "sykepic_tpu/ops/pallas_preprocess.py:114",
        "launches": launches,
        "pipeline_launches": fused_launches["k1"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }, {
        # ms, plain_ms and bound_ms: the seven floods of the first fused
        # dispatch, summed; launches: every form in the fused run
        "name": "flood",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/flood.cu",
        "replaces": "sykepic_tpu/ops/pallas_flood.py:102",
        "launches": sum(k2_launches.values()),
        "launches_by_form": k2_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "device_ms": k2["device_ms"],
        "host_us": k2["host_us"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
    }], "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
