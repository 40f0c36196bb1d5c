#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sykepic_tpu_torch``) on one NVIDIA
card: the ``prob`` main path at full width, and every kernel on it held
against its plain PyTorch version.

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
    from torch.profiler import ProfilerActivity, profile

    from sykepic_tpu_torch.compute.engine import Classifier

    clf = Classifier(model_dir, batch_size=BATCH)
    for _ in clf.classify_blocks(sample_blocks(samples)):  # warm
        pass
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in clf.classify_blocks(sample_blocks(samples)):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    k1_ms = sum(ms for key, ms, _ in kernels if "resize_pad" in key)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit({"phase": "profile", "wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / (1e3 * wall) if wall else None,
          "k1_ms": k1_ms, "k1_share_of_device": k1_ms / busy_ms
          if busy_ms else None, "kernels_seen": len(kernels),
          "top": [{"kernel": key[:80], "ms": ms, "calls": n}
                  for key, ms, n in top]})


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
    phase_env(smi)
    model_dir = build_model_dir(WORK)
    raw = WORK / "raw"
    counts = build_raw(raw, N_ROIS, seed=42, start=datetime(2018, 7, 12))
    main_case = phase_kernel(model_dir, list(counts))
    launches = phase_prob(model_dir, raw, counts)
    check(launches > 0, "the main path never launched K1")
    phase_profile(model_dir, list(counts))
    k = main_case["f32"]
    emit({"kernels": [{
        "name": "resize_pad",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/resize_pad.cu",
        "replaces": "sykepic_tpu/ops/pallas_preprocess.py:114",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }], "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
