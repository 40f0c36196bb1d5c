#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sykepic_tpu_torch``) on one NVIDIA
card: the ``prob`` main path, the fused ``pipeline --device-features``
path, ``train``, the other families, the multi-GPU path, the deployment
path (the host-thread ``pipeline``, ``watch`` and ``export``) at full
width, the pandas CSV sub-commands and ``train``'s side modes, and every
kernel on them held against its plain PyTorch version.

Run from the root of a checkout, on a machine with a card::

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA,
   scipy and numpy versions, whether pandas, matplotlib and tqdm import,
   the host's cores, and
   the build seconds of ``csrc/*.cu`` (nvcc, one process per source, all
   started together, into ``build/kernels/``) and of the native host
   library.
1b. ``host_native``: the port's native host library as this machine's
   compiler built it, against its NumPy twins (``native.lib()`` patched to
   None), exact: the ADC parser on 50 fuzzed bodies, the shelf packer
   (placement, blit, modes) on 3,000 ROIs in ``bench.py``'s size mix, the
   wire encoder on those windows and on saturated, ramp and noise windows,
   and the PNG unfilter at 1, 3 and 4 bytes a pixel with all five filters;
   each side's host seconds.
2. ``kernel_resize_pad``: K1 against its plain version at the main path's
   shapes (the first shelf dispatch of the workload, a crafted shelf
   dispatch, slot canvases of 64x128 and one of 512x512), in float32
   (max |diff| <= 1e-3/255) and bfloat16 (within one bf16 ulp of the plain
   version cast to bf16). Kernel ms are the median of 20 launches timed
   with CUDA events, beside the device ms (torch.profiler, per kernel it
   recorded of 20 launches), the loop ms (20 back-to-back calls between two
   events), the host us a call (100 calls without a synchronisation between
   them), the plain version's ms, the least time the card could take
   (bytes over the memory rate, operations over the float32 rate), the
   share of it by device ms, the copy floor (``out.copy_`` from an equal
   tensor, back to back: the card's practical rate for the output's bytes)
   and the store path the launch plan took (``bulk`` or ``vector``).
2b. ``kernel_layernorm``: ConvNeXt's eval LayerNorm kernel
   (``csrc/layernorm.cu``) at ConvNeXt-T's four widths of a 2,048-slot
   dispatch of 180x180 ROIs (2048 x 45x45 x 96, 22x22 x 192, 11x11 x 384,
   5x5 x 768), with and without the convolution's bias: against its plain
   version and ``F.layer_norm`` of the sum (max |diff| <= 1e-5), one launch
   a call; ms by events, device ms (torch.profiler), loop ms, host us a
   call, the byte bound (8 B a value at 3.35 TB/s) and the share of it, the
   plain version's ms and ``F.layer_norm``'s (the library yardstick, timed
   only). Then ConvNeXt-T's eval forward of one 2,048-slot dispatch with
   the kernel and with ATen's LayerNorm: device ms of each, 22 launches a
   forward, probabilities within 1e-5.
2c. ``kernel_depthwise``: the eval depthwise convolution kernel
   (``csrc/depthwise.cu``) at ConvNeXt-T's four shapes (7x7 at 45x45 x 96,
   22x22 x 192, 11x11 x 384, 5x5 x 768) and EfficientNet-B0's twelve (3x3
   and 5x5 at stride 1 and 2, 90x90 x 32 to 6x6 x 1152) of a 2,048-slot
   dispatch of 180x180 ROIs: against its plain version and ``F.conv2d``
   (cuDNN, TF32 off) within 1e-5 absolute plus 1e-5 relative, one launch a
   call; the tile its plan took, ms by events, device ms (torch.profiler),
   loop ms, host us a call, the byte bound (each input and output value
   once, at 3.35 TB/s) and the share of it, the FLOP bound, the plain
   version's ms and ``F.conv2d``'s (``library_ms``, back to back, and its
   device ms). Then ConvNeXt-T's and EfficientNet-B0's eval forwards of one
   2,048-slot dispatch with the kernels and with ATen's path (the rule
   patched off): device ms of each, 18 and 16 launches a forward,
   probabilities within 1e-5.
2d. ``kernel_window_attention``: Swin's window-attention kernel
   (``csrc/window_attention.cu``) at Swin-T's eight block shapes of a
   2,048-slot dispatch of 180x180 ROIs (45x45 x 96 with 3 heads to 6x6 x
   768 with 24, each with and without the shift) on ``qkv`` of the
   unpadded map: against its plain version (max |diff| <= 1e-5), one launch
   a call; the heads a block its plan took, ms by events, device ms
   (torch.profiler), loop ms, host us a call, the bound (the real tokens'
   q, k, v and output at 3.35 TB/s, or the two products' FLOPs at 67
   TFLOP/s) and the share of it, the benchmark reader's padded-window
   bytes beside it, the plain version's ms and SDPA's memory-efficient
   kernel on the same block's padded windows (``library_ms``, timed only).
   Then Swin-T's eval forward of one 2,048-slot dispatch with the kernel
   and with SDPA's path (the rule patched off): device ms of each, 12
   launches a forward, probabilities within 1e-5.
3. ``prob``: a full-width ResNet18 model dir (the repo's config, seeded
   random weights saved as a reference-layout ``best_state.pth``) and a
   workload of the fixture sample plus 20,000 synthetic ROIs in
   ``bench.py``'s size mix, written as genuine ``.adc/.roi/.hdr`` triplets,
   go through ``python -m sykepic_tpu_torch prob``'s ``main`` with
   ``-b 2048``: shelf packing with the wire codec on (the default), again
   warm, and with the codec off. Every CSV is checked, and K1's launch
   count must equal the number of dispatches. A subset runs
   on the CPU and on the card in float32 (same argmax, |dp| <= 1.2e-5) and
   bfloat16 (``bf16_contract``: the argmax agrees on every ROI whose
   float32 top-two gap exceeds twice ``BF16_DRIFT_BOUND``, 1e-2, and no
   probability moves further than that bound; the near ties are counted),
   and the e2e runs in bfloat16 through the same `prob` code.
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
   launches 7x the dispatches whose canvas picks that form. Then a warm
   stream under ``torch.profiler`` (K2's device time split by form).
7. ``pipeline_card_vs_cpu``: the fused pass on the 202-ROI comparison set,
   the port on the CPU against the card: probabilities within 1.2e-5, and
   over the ROIs with area >= 50 at least 90% with area, major and minor
   identical (area equal, axes within 1e-5 relative).
7b. ``edge_zero_roi``: a sample whose adc rows are all empty triggers
   through ``prob`` and ``pipeline --device-features``: each writes its
   header-only CSVs, and K1 and K2, counted from 0 around each run,
   launch 0 times.
8. ``train``: ``python -m sykepic_tpu_torch train`` (``main``, in-process)
   on a synthetic PNG set written with the port's own PNG writer (3,000
   images in ``bench.py``'s size mix, dealt out to 8 classes by size with
   noise, so ROI size and brightness follow the class; half the files with
   Sub/Up/Average/Paeth rows, half with filter 0; split 0.8/0.1/0.1) at
   the full width of ``train.ini.example``: ResNet18 on
   3x180x180, head 256,128, batch 256, bfloat16 autocast, Adam, flip,
   translate, zoom and brightness, the device-resident dataset with
   stratified mixed batches, and warmup steps 1/2/3 so that epochs 1, 2 and
   3 run stages 0, 1 and 2, 4 epochs. Checked: the train loss is finite and
   falls from epoch 1 to 4; K1's train-form launches equal the mixed
   buckets x steps of every epoch and its eval-form launches the eval
   batches; every K1 launch of the first step (one per bucket, recorded as
   the step made it) equals the plain version on the same inputs, the
   step's bfloat16 output within one bf16 ulp and the same inputs in
   float32 within 1e-3/255; the model directory holds every artifact; the
   port's ``prob`` on the card reads it and writes a CSV. Printed: train
   images/s over the warm epochs 2-4, one more warm epoch under
   torch.profiler (device busy share, device ms by kind), and the set-up:
   the datasets' build seconds, PNG decode seconds by row filters (summed
   over the decode threads), and a single-threaded decode of 200 files of
   each kind with the native unfilter and with its Python twin.
9. ``kernel_resize_pad_train``: K1's train form against its plain version
   on 2,048 slots of the largest store of that run: random affines with
   both flips, zoom 0.6 and 1.4, translations at -limit and +limit, in
   float32 (``bright_on``, ``bright_off``; max |diff| <= 1e-3/255) and in
   bfloat16 (``bright_on_bf16``, ``bright_off_bf16``; within one bf16 ulp of
   the plain version cast to bf16; the store ``[train] dtype = bfloat16``
   writes), each with brightness (the kernel's level table) on and off; ms
   by events (one call each), device ms (torch.profiler, per kernel it
   recorded of 20 launches), loop ms (20 back-to-back calls between two
   events, with a new output each and into one preallocated output), host
   us a call, plain ms, the byte bound (uint8 reads, the slot inputs and the NHWC writes, 4
   or 2 bytes an element, at 3.35 TB/s), the share of it by device ms and
   the copy floor of the output.
10. ``train_step_card_vs_cpu``: one float32 train step (no augmentation, no
   dropout) of the full-width model on 32 images of the set, on the card
   and on the CPU from the same weights: loss within 1e-4 relative, the
   BatchNorm running variances within 1e-3 relative.
11. ``families``: seven other families at the full width of the repo's
   config (3x180x180, head 256,128, 50 classes; seeded random weights and
   BatchNorm running statistics, ``best_state.msgpack`` written by the
   port): ``efficientnet_b0``, ``efficientnet_v2_s``, ``mobilenet_v3_large``,
   ``vgg16_bn``, ``alexnet``, ``convnext_tiny``, ``regnet_y_400mf``,
   ``swin_t``. Each goes
   through ``prob`` on the card (float32, ``-b 2048``) on the fixture sample
   plus 4,000 synthetic ROIs in the same size mix, cold and warm, every CSV
   checked and K1 launched once per dispatch; then a profiled warm stream
   (busy share, the three largest device-time kinds) and the card against
   the CPU on 66 ROIs (within 1.2e-5, the same argmax); the cold run
   launches the LayerNorm kernel 22 times a dispatch for ConvNeXt-T and 29
   for Swin-T, the other families never; Swin-T's launches the
   window-attention kernel 12 times a dispatch (its counter set to 0 just
   before), the other families never; the depthwise kernel launches 18
   times a dispatch for ConvNeXt-T, 16 for EfficientNet-B0, 30 for
   EfficientNet-V2-S and 15 for MobileNetV3-large, and never for the
   others (nor for ResNet18 in ``prob``). Then ``train`` for two epochs
   (stages 0 and 1, bf16, batch 256, Adam) on the ``train`` phase's set:
   ``efficientnet_b0`` with flip, translate, zoom, rotate (``max_rotation``
   10) and brightness, so K1's eval form and the rotation warp run on the
   card, and ``convnext_tiny`` with K1's train form; the loss must fall,
   K1's launches by form must equal the bucket-steps and eval batches, and
   ``prob`` must read the trained directory. Printed: images/s of epoch 2
   and of one more steady epoch, and a profiled epoch's device time by
   kind.

12. ``parallel``: the multi-GPU path on the one card, a NCCL group at
   world size 1 with a data mesh over it
   (``sykepic_tpu_torch.parallel``). The data-parallel trainer (full
   width, the ``train`` phase's set, batch 256, bfloat16, flip,
   translate, zoom and brightness, three whole epochs at stage 2, cuDNN
   deterministic) against the trainer without a group from the same
   weights and seed: the steady epochs' losses within 1e-5 relative (the
   trainer without a group run twice gives the run-to-run floor); K1's
   train form launched once per bucket and step. ``prob`` on the
   workload through ``Classifier(mesh=data_mesh())`` against the run
   without a mesh (the same files, ids and argmax, within 1.2e-5; K1 once
   per dispatch), and the fused pass on the comparison set (features
   within 1e-5 relative; K1 and K2 launched). Printed: the steady step ms
   with the group and without it, ``prob``'s ROIs/s with the mesh and
   without it, the launches, and
   ``torch.distributed.is_nccl_available()``.
13. ``pipeline_host``: the fixture plus 1,000 synthetic ROIs (samples of
   100) through ``python -m sykepic_tpu_torch pipeline ... -b 2048 -w 8``,
   the host-thread mode (features on 8 host threads beside the
   classification on the card), cold and warm under torch.profiler:
   every sample returned, K1 launched once per dispatch; the ``.prob.csv``
   files equal ``prob``'s on the same samples (ids and argmax, within
   1.2e-5) and the ``.feat.csv`` files are byte-identical to ``feat -p``'s
   (``# version=tpu-v1``). Printed: e2e ROIs/s, the device's busy share,
   the host's cores, and the host features' own ROIs/s on 200 of the ROIs
   at 1, 2, 4 and 8 threads.
14. ``watch``: ``watch.run(..., interval=0, settle_seconds=0,
   max_cycles=2)`` on the card over the fixture and one synthetic sample,
   a third copied in by the sleep hook after cycle 1: each sample goes
   through ``pipeline.main`` exactly once, all three are returned, K1
   launches, and the CSVs equal ``pipeline_host``'s.
15. ``export``: ``python -m sykepic_tpu_torch export`` on the ``train``
   phase's model directory (a port-written ``best_state.msgpack``); a
   directory holding only ``config.ini``, ``class_names.txt`` and that
   ``best_state.pth`` runs ``prob`` on the card over the comparison set
   exactly as the msgpack directory does (max |dp| 0.0).
16. ``csv_tools``: the pandas CSV sub-commands, each its own ``python -m
   sykepic_tpu_torch`` process, on the ``.prob.csv`` and ``.feat.csv``
   trees of ``pipeline_host`` (11 samples): ``class``, ``size`` (with an
   exclusion list), ``abundance``, ``class_stats``,
   ``features_per_prediction``, ``evaluate --search --best-out`` (on a
   selection tree labelled from the prob CSVs) and ``frequency``. Every
   output exists, one row a sample (``class``, ``size``, ``abundance``,
   ``frequency``); at zero thresholds ``abundance``'s per-class counts equal
   the argmax counts computed here with numpy and ``frequency``'s cells sum
   to the ROIs; ``size``'s per-group counts sum to the ROIs its exclusion
   list lets through. Printed: each command's seconds (host work).
17. ``train_side``: ``train``'s side modes on the ``train`` phase's set:
   ``--collage 8 8`` on the card (K1's eval form with ``raw``, then the
   rotation warp) with K1's launch count set to 0 just before and read
   just after, each of its K1 calls held against the plain version
   (max |diff| <= 1e-3 on the 0-255 scale); with augmentations off, the
   card's collage equal to ``--device cpu``'s pixel for pixel;
   ``--save-images`` with ``--dist`` (every image copied; the plot written
   where matplotlib imports, a raise where it does not).

Then the ``kernels`` line (K1's eval form, with its launches on every
path, the collage's among them, and its bfloat16 case, K1's train form,
with its bfloat16 case, K2, the zero-ROI runs' launches among them, and
the LayerNorm, depthwise and window-attention kernels, their launches those
of the ``families`` phase's cold ``prob`` runs), the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a card, or outside a checkout, the script exits non-zero at once.
Everything it writes goes to ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
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
# what the kernels line keeps of a K1 case's bfloat16 run
K1_LINE_KEYS = ("max_abs_err", "ms", "device_ms", "loop_ms", "share_of_bound",
                "copy_floor_ms", "plain_ms", "bound_ms", "bound_by")

N_ROIS = 20_000
PER_SAMPLE = 500
BATCH = 2048  # bench.py:83
N_COMPARE = 200  # ROIs of the CPU-versus-card comparison, plus the fixture
TIMED_LAUNCHES = 20
TIMED_PLAIN = 5
PROB_BOUND = 1.2e-5  # one 1e-5 quantum of the fixed-point rows
# bfloat16 against float32 prob on this script's seeded He-normal weights:
# the largest |dp| allowed. The JAX package's own bf16 drifts 7.4e-3 on the
# CPU on such weights over 64 ROIs (tests/test_torch_bf16_parity.py)
BF16_DRIFT_BOUND = 1e-2

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


def build_raw(raw_dir: Path, n_rois: int, seed: int, start: datetime,
              per_sample: int = PER_SAMPLE):
    """The fixture sample plus ``n_rois`` synthetic ROIs in samples of
    ``per_sample``; returns ``{sample path: number of ROIs}``."""
    raw_dir.mkdir(parents=True)
    for suffix in (".adc", ".roi", ".hdr"):
        shutil.copy(FIXTURE.with_suffix(suffix), raw_dir)
    images = fixture_images()
    rng = np.random.default_rng(seed)
    counts = {raw_dir / FIXTURE.name: len(images)}
    for s in range(-(-n_rois // per_sample)):
        n = min(per_sample, n_rois - s * per_sample)
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


def count_dispatches(paths) -> int:
    """Dispatches the engine makes for these samples with ``-b BATCH``:
    the same shelf packing pass, counted on the host."""
    from sykepic_tpu_torch.ingest import shelf

    gen = shelf.pack_shelves(sample_blocks(paths), pre_shrink_to=(180, 180),
                             slot_cap=min(shelf.SLOT_CAP, max(BATCH, 1024)))
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
    import scipy  # the host features' (feat, pipeline, watch)

    importable = {}
    # pandas: feat --matlab and the CSV sub-commands; matplotlib: the
    # training curves and train --dist; tqdm: progress bars
    for name in ("pandas", "matplotlib", "tqdm"):
        try:
            __import__(name)
            importable[name] = True
        except ImportError:
            importable[name] = False
    out = {"phase": "env", "gpu": smi, "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0], "scipy": scipy.__version__,
           "numpy": np.__version__,
           **{f"{k}_importable": v for k, v in importable.items()},
           "cpu_count": os.cpu_count(), "build_s": kernel_s,
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


def loop_ms(fn, reps: int) -> float:
    """Mean time of ``reps`` back-to-back calls between two CUDA events:
    the device's time per call once the launches run ahead of it."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profiled_kernels(fn, word: str, reps: int) -> tuple[float, int]:
    """Device ms and number of the kernels whose name holds ``word`` in
    torch.profiler's trace of ``reps`` calls of ``fn`` (the raw trace
    events; ``key_averages`` was seen to keep 9 of 20)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sentinel = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # torch.profiler has been seen to drop the first kernel of a
        # profile on the card: a fill goes first, and only it may be dropped
        sentinel.fill_(1.0)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    hits = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and word in e.name()]
    return (sum(e.duration_ns() / 1e6 if hasattr(e, "duration_ns")
                else e.duration_us() / 1e3 for e in hits), len(hits))


PROFILE_TRIES = 3


def profiled_launches(fn, word: str, reps: int, counter, what: str) -> float:
    """Device ms of the kernels whose name holds ``word`` over ``reps``
    calls of ``fn`` (:func:`profiled_kernels`), checked to be one kernel
    launched (``counter()``, the module's launch count) and recorded a
    call. torch.profiler has been seen to lose a few of a profile's kernels
    on the card (18 of 20), so a profile that records fewer than ``reps``
    is taken again, up to :data:`PROFILE_TRIES` times."""
    for _ in range(PROFILE_TRIES):
        n0 = counter()
        prof_ms, recorded = profiled_kernels(fn, word, reps)
        launched = counter() - n0
        check(launched == reps + 1, f"{what}: {launched} launches for "
              f"{reps} calls and a warm-up")
        if recorded == reps:
            return prof_ms
    raise AssertionError(f"{what}: {recorded} kernels recorded for {reps} "
                         f"calls, {PROFILE_TRIES} profiles in a row")


def copy_floor_ms(out: torch.Tensor) -> float:
    """The card's practical write rate for ``out``'s bytes: back-to-back
    ``out.copy_(other)`` from an equal tensor (reads and writes as many
    bytes again; beside the datasheet bound, not instead of it)."""
    other = torch.zeros_like(out)
    return loop_ms(lambda: out.copy_(other), TIMED_LAUNCHES)


def k1_timings(call, got: torch.Tensor, bound_ms: float) -> dict:
    """K1's times for one call: the median of single calls by events, the
    device time of a recorded kernel (torch.profiler, per kernel it
    recorded), back to back, the host time of a call (``host_us``), the
    share of the bound by device time, and the copy floor of its output."""
    prof_ms, recorded = profiled_kernels(call, "resize_pad", TIMED_LAUNCHES)
    device_ms = prof_ms / recorded if recorded else None
    return {"ms": time_ms(call, TIMED_LAUNCHES),
            "device_ms": device_ms,
            "device_kernels_recorded": recorded,
            "loop_ms": loop_ms(call, TIMED_LAUNCHES),
            "host_us": host_us(call),
            "share_of_bound": bound_ms / device_ms if device_ms else None,
            "copy_floor_ms": copy_floor_ms(got)}


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
        bound_ms = 1e3 * max(bytes_s, ops_s)
        out[tag] = {
            "max_abs_err": float(err.max()),
            "store": resize_pad.plan(target, target, 3, dtype,
                                     got.data_ptr()).store,
            **k1_timings(lambda: resize_pad.resize_pad(
                pix, m, target, target, 3, dtype), got, bound_ms),
            "plain_ms": time_ms(lambda: preprocess.resize_pad_plain(
                pix, m, target, target, 3, dtype), TIMED_PLAIN),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bytes": read + written,
        }
    out["launches"] = resize_pad.launches
    emit(out)
    return out


def first_shelf_dispatch(model_dir: Path, samples):
    """The uint8 windows and slot metadata of ``prob``'s first shelf
    dispatch of ``samples``."""
    from sykepic_tpu_torch.compute.engine import Classifier
    from sykepic_tpu_torch.ingest import shelf

    clf = Classifier(model_dir, batch_size=BATCH)  # host metadata only
    first = next(shelf.pack_shelves(
        sample_blocks(samples), pre_shrink_to=(180, 180), compute_modes=True,
        slot_cap=clf._shelf_slot_cap))
    return first.windows, clf._shelf_meta(first)


def phase_kernel(model_dir: Path, samples) -> dict:
    """K1 at the main path's shapes; returns the main-path case."""
    from sykepic_tpu_torch.ingest import shelf
    from sykepic_tpu_torch.ops import preprocess

    main_case = k1_case("shelf_first_dispatch",
                        *first_shelf_dispatch(model_dir, samples))

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


# ConvNeXt-T's four LayerNorm widths at a 2,048-slot dispatch of 180x180
# ROIs: (channels, side of the NHWC map)
LN_SHAPES = ((96, 45), (192, 22), (384, 11), (768, 5))
LN_TOL = 1e-5  # float32 sums in two orders and rsqrtf's 2 ulp, values < 8
LN_FORWARD_TOL = 1e-5  # probabilities, kernel path against ATen's


def ln_case(c: int, side: int, pre: bool) -> dict:
    """The LayerNorm kernel at one width of a 2,048-slot dispatch against
    its plain version (both on the card) and ``F.layer_norm``; with
    ``pre``, the preceding convolution's bias added in the kernel."""
    from torch.nn import functional as F

    from sykepic_tpu_torch.ops import layernorm

    g = torch.Generator(device="cuda").manual_seed(c)
    x = 2 * torch.randn(BATCH, side, side, c, device="cuda", generator=g)
    x += 0.5
    w = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    pb = 0.5 * torch.randn(c, device="cuda", generator=g) if pre else None
    eps = 1e-6

    def call():
        return layernorm.layernorm(x, w, b, eps, pre_bias=pb)

    def plain():
        return layernorm.layernorm_plain(x, w, b, eps, pre_bias=pb)

    def library():
        return F.layer_norm(x, (c,), w, b, eps)

    got = call()
    err = float((got - plain()).abs().max())
    lib_err = float((got - F.layer_norm(x if pb is None else x + pb, (c,),
                                        w, b, eps)).abs().max())
    check(err <= LN_TOL and lib_err <= LN_TOL,
          f"layernorm {c}x{side}: max |diff| {err} (plain), {lib_err} "
          "(F.layer_norm)")
    prof_ms = profiled_launches(call, "layernorm", TIMED_LAUNCHES,
                                lambda: layernorm.launches,
                                f"layernorm {c}x{side}")
    lib_prof_ms, lib_recorded = profiled_kernels(library, "layer_norm",
                                                 TIMED_LAUNCHES)
    device_ms = prof_ms / TIMED_LAUNCHES
    rows = BATCH * side * side
    bound_ms = 1e3 * (8 * rows * c + (4 * c if pre else 0)) \
        / MEMORY_BYTES_PER_S
    del got
    return {"channels": c, "shape": [BATCH, side, side, c], "pre_bias": pre,
            "lanes_per_lane": list(layernorm.plan(c)),
            "max_abs_err": err, "max_abs_err_library": lib_err,
            "ms": time_ms(call, TIMED_LAUNCHES), "device_ms": device_ms,
            "loop_ms": loop_ms(call, TIMED_LAUNCHES),
            "host_us": host_us(call), "bound_ms": bound_ms,
            "share_of_bound": bound_ms / device_ms,
            "plain_ms": time_ms(plain, TIMED_PLAIN),
            "library_ms": loop_ms(library, TIMED_LAUNCHES),
            "library_device_ms": (lib_prof_ms / lib_recorded
                                  if lib_recorded else None)}


def ln_forward() -> dict:
    """ConvNeXt-T's eval forward of one 2,048-slot dispatch on the card,
    channels_last, with the kernel path and with ATen's LayerNorm (the
    rule patched off): device ms of each, the kernel's launches a forward
    (22) and the largest gap between their probabilities."""
    from sykepic_tpu_torch.models import convnext, registry
    from sykepic_tpu_torch.ops import layernorm

    model = registry.init_weights(registry.build_model("convnext_tiny", 50),
                                  0)
    with torch.no_grad():  # block scales of 1, so the blocks count
        for m in model.modules():
            if isinstance(m, convnext.CNBlock):
                m.layer_scale.fill_(1.0)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(BATCH, 180, 180, 3, device="cuda", generator=g).permute(
        0, 3, 1, 2)

    def forward():
        with torch.inference_mode():
            return torch.softmax(model(x) * np.log(1.3), dim=-1)

    n0 = layernorm.launches
    kernel = forward()
    per_forward = layernorm.launches - n0
    kernel_ms = loop_ms(forward, 3)
    rule = convnext.eval_kernel_runs
    convnext.eval_kernel_runs = lambda *a: False
    try:
        n0 = layernorm.launches
        aten = forward()
        check(layernorm.launches == n0, "the patched rule launched the "
              "kernel")
        aten_ms = loop_ms(forward, 3)
    finally:
        convnext.eval_kernel_runs = rule
    dp = float((kernel - aten).abs().max())
    check(per_forward == 22 and dp <= LN_FORWARD_TOL,
          f"convnext_tiny forward: {per_forward} launches, max |dp| {dp}")
    return {"launches_per_forward": per_forward, "max_abs_dp": dp,
            "kernel_ms": kernel_ms, "aten_ms": aten_ms}


def phase_kernel_layernorm(smi: str) -> dict:
    """ConvNeXt's eval LayerNorm kernel at its four widths, with and
    without the convolution's bias, and ConvNeXt-T's forward with it
    against ATen's; returns the stage-1 case with the bias."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [ln_case(c, side, pre) for c, side in LN_SHAPES
             for pre in (True, False)]
    out = {"phase": "kernel_layernorm", "gpu": smi, "cases": cases,
           "forward": ln_forward()}
    emit(out)
    torch.cuda.empty_cache()
    return cases[0]


# (k, stride, map side, channels) of a 180x180 ROI's depthwise convolutions:
# ConvNeXt-T's four, then EfficientNet-B0's twelve distinct ones
DW_SHAPES = ((7, 1, 45, 96), (7, 1, 22, 192), (7, 1, 11, 384), (7, 1, 5, 768),
             (3, 1, 90, 32), (3, 2, 90, 96), (3, 1, 45, 144), (5, 2, 45, 144),
             (5, 1, 23, 240), (3, 2, 23, 240), (3, 1, 12, 480),
             (5, 1, 12, 480), (5, 1, 12, 672), (5, 2, 12, 672),
             (5, 1, 6, 1152), (3, 1, 6, 1152))
# float32 sums of k*k products in another order, and one rounding a tap
# (fmaf) against two; outputs below 8
DW_TOL = 1e-5
DW_FORWARD_TOL = 1e-5  # probabilities, kernel path against ATen's
# depthwise convolutions a forward of each family the kernel takes
DW_PER_FORWARD = {"convnext_tiny": 18, "efficientnet_b0": 16,
                  "efficientnet_v2_s": 30, "mobilenet_v3_large": 15}


def dw_case(k: int, stride: int, side: int, c: int) -> dict:
    """The depthwise kernel at one shape of a 2,048-slot dispatch against
    its plain version (both on the card) and ``F.conv2d``."""
    from torch.nn import functional as F

    from sykepic_tpu_torch.ops import depthwise

    g = torch.Generator(device="cuda").manual_seed(k * 1000 + side)
    x = torch.randn(BATCH, side, side, c, device="cuda", generator=g)
    w = torch.randn(c, 1, k, k, device="cuda", generator=g) / k
    xn = x.permute(0, 3, 1, 2)  # the channels_last NCHW view

    def call():
        return depthwise.depthwise(x, w, stride)

    def plain():
        return depthwise.depthwise_plain(x, w, stride)

    def library():
        return F.conv2d(xn, w, stride=stride, padding=(k - 1) // 2,
                        groups=c)

    got = call()
    want = plain()
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=DW_TOL, atol=DW_TOL)
    del want
    lib = library().permute(0, 2, 3, 1)
    lib_err = float((got - lib).abs().max())
    ok = ok and torch.allclose(got, lib, rtol=DW_TOL, atol=DW_TOL)
    del lib
    check(ok, f"depthwise {k}x{k}/{stride} {side}x{c}: max |diff| {err} "
          f"(plain), {lib_err} (F.conv2d)")
    prof_ms = profiled_launches(call, "depthwise", TIMED_LAUNCHES,
                                lambda: depthwise.launches,
                                f"depthwise {k}x{k}/{stride} {side}x{c}")
    # cuDNN's depthwise kernels (conv2d_c1_k1_nhwc,
    # convolve_common_engine_float_NHWC), a call
    lib_prof_ms, _ = profiled_kernels(library, "conv", TIMED_LAUNCHES)
    device_ms = prof_ms / TIMED_LAUNCHES
    ho = depthwise.out_size(side, stride)
    bytes_s = 4 * (BATCH * side * side * c + BATCH * ho * ho * c
                   + c * k * k) / MEMORY_BYTES_PER_S
    flops_s = 2 * BATCH * ho * ho * c * k * k / F32_OPS_PER_S
    bound_ms = 1e3 * max(bytes_s, flops_s)
    del got
    return {"k": k, "stride": stride, "shape": [BATCH, side, side, c],
            "tile": list(depthwise.plan(k, stride, ho, ho)),
            "max_abs_err": err, "max_abs_err_library": lib_err,
            "ms": time_ms(call, TIMED_LAUNCHES), "device_ms": device_ms,
            "loop_ms": loop_ms(call, TIMED_LAUNCHES),
            "host_us": host_us(call), "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= flops_s else "ops",
            "flop_bound_ms": 1e3 * flops_s,
            "share_of_bound": bound_ms / device_ms,
            "plain_ms": time_ms(plain, TIMED_PLAIN),
            "library_ms": loop_ms(library, TIMED_LAUNCHES),
            "library_device_ms": lib_prof_ms / TIMED_LAUNCHES}


def dw_forward(name: str) -> dict:
    """``name``'s eval forward of one 2,048-slot dispatch on the card,
    channels_last, with the kernel path and with ATen's (the rule patched
    off): device ms of each, the depthwise kernel's launches a forward and
    the largest gap between their probabilities."""
    from sykepic_tpu_torch.models import convnext, layers, registry
    from sykepic_tpu_torch.ops import depthwise

    model = registry.init_weights(registry.build_model(name, 50), 0)
    with torch.no_grad():  # block scales of 1, so the blocks count
        for m in model.modules():
            if isinstance(m, convnext.CNBlock):
                m.layer_scale.fill_(1.0)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand(BATCH, 180, 180, 3, device="cuda", generator=g).permute(
        0, 3, 1, 2)

    def forward():
        with torch.inference_mode():
            return torch.softmax(model(x) * np.log(1.3), dim=-1)

    n0 = depthwise.launches
    kernel = forward()
    per_forward = depthwise.launches - n0
    kernel_ms = loop_ms(forward, 3)
    rules = (layers.eval_kernel_runs, convnext.eval_kernel_runs)
    layers.eval_kernel_runs = convnext.eval_kernel_runs = lambda *a: False
    try:
        n0 = depthwise.launches
        aten = forward()
        check(depthwise.launches == n0, "the patched rule launched the "
              "depthwise kernel")
        aten_ms = loop_ms(forward, 3)
    finally:
        layers.eval_kernel_runs, convnext.eval_kernel_runs = rules
    dp = float((kernel - aten).abs().max())
    want = DW_PER_FORWARD[name]
    check(per_forward == want and dp <= DW_FORWARD_TOL,
          f"{name} forward: {per_forward} depthwise launches for {want}, "
          f"max |dp| {dp}")
    return {"network": name, "launches_per_forward": per_forward,
            "max_abs_dp": dp, "kernel_ms": kernel_ms, "aten_ms": aten_ms}


def phase_kernel_depthwise(smi: str) -> dict:
    """The eval depthwise kernel at ConvNeXt-T's and EfficientNet-B0's
    shapes, and both networks' forwards with it against ATen's; returns
    ConvNeXt-T's stage-1 case."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for shape in DW_SHAPES:
        cases.append(dw_case(*shape))
        torch.cuda.empty_cache()
    forwards = [dw_forward(name) for name in ("convnext_tiny",
                                              "efficientnet_b0")]
    emit({"phase": "kernel_depthwise", "gpu": smi, "cases": cases,
          "forwards": forwards,
          # each shape's device ms times its convolutions a forward
          "convnext_tiny_device_ms_per_dispatch": sum(
              case["device_ms"] * n for case, n in zip(cases, (3, 3, 9, 3))),
          "efficientnet_b0_device_ms_per_dispatch": sum(
              case["device_ms"] * n for case, n in zip(
                  cases[4:], (1, 1, 1, 1, 1, 1, 2, 1, 2, 1, 3, 1)))})
    torch.cuda.empty_cache()
    return cases[0]


# Swin-T's attention blocks of a 180x180 ROI: (map side, channels, heads,
# shift), and how many blocks of each a forward runs; stage 4's 6x6 map
# pads to one window, so its shift is dropped
WA_SHAPES = ((45, 96, 3, 0), (45, 96, 3, 3), (23, 192, 6, 0),
             (23, 192, 6, 3), (12, 384, 12, 0), (12, 384, 12, 3),
             (6, 768, 24, 0), (6, 768, 24, 3))
WA_BLOCKS = (1, 1, 1, 1, 3, 3, 1, 1)
# outputs are convex combinations of 49 values of v (below 8 here): float32
# sums in another order, __expf (about 2^-22 relative plus 2^-24 |x|)
# against torch's exp
WA_TOL = 1e-5
WA_FORWARD_TOL = 1e-5  # probabilities, kernel path against SDPA's


def wa_case(side: int, c: int, heads: int, shift: int) -> dict:
    """The window-attention kernel at one block shape of a 2,048-slot
    dispatch against its plain version (both on the card), with SDPA's
    memory-efficient kernel on the same block's padded windows beside it
    (``library_ms``, timed only)."""
    from torch.nn import functional as F

    from sykepic_tpu_torch.models import swin
    from sykepic_tpu_torch.ops import window_attention as wa

    m = swin.ShiftedWindowAttention(c, swin.WINDOW, shift, heads).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(side * 10 + shift)
    with torch.no_grad():
        m.qkv.weight.copy_(torch.randn(3 * c, c, device="cuda", generator=g)
                           * c ** -0.5)
        m.qkv.bias.copy_(torch.randn(3 * c, device="cuda", generator=g) / 2)
        m.relative_position_bias_table.normal_(generator=g)
        x = torch.randn(BATCH, side, side, c, device="cuda", generator=g)
        qkv = F.linear(x, m.qkv.weight, m.qkv.bias)
    del x
    pad = -(-side // swin.WINDOW) * swin.WINDOW
    shifts = m.shifts(pad, pad)
    args = (qkv, m.qkv.bias.detach(), m.relative_position_bias_table.detach(),
            heads, shifts)

    def call():
        return wa.window_attention(*args)

    def plain():
        return wa.window_attention_plain(*args)

    got = call()
    err = float((got - plain()).abs().max())
    check(err <= WA_TOL, f"window attention {side}x{c}/{heads} shift "
          f"{shifts}: max |diff| {err} (plain)")
    del got
    prof_ms = profiled_launches(call, "window_attention", TIMED_LAUNCHES,
                                lambda: wa.launches,
                                f"window attention {side}x{c}")
    device_ms = prof_ms / TIMED_LAUNCHES
    # SDPA on the padded, rolled windows, laid out as the model's SDPA path
    # lays them (windows and heads on its head axis), with its mask
    n = swin.WINDOW * swin.WINDOW
    with torch.no_grad():
        full = m.qkv.bias.detach().expand(BATCH, pad, pad, 3 * c).clone()
        full[:, :side, :side] = qkv
        full = torch.roll(full, (-shifts[0], -shifts[1]), (1, 2))
        nh = pad // swin.WINDOW
        q, k, v = full.view(BATCH, nh, swin.WINDOW, nh, swin.WINDOW, 3,
                            heads, c // heads).permute(
            5, 0, 1, 3, 6, 2, 4, 7).reshape(3, BATCH, nh * nh * heads, n,
                                            c // heads).unbind(0)
        del full
        mask = m.attn_mask(pad, pad, q)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    lib_prof_ms, lib_recorded = profiled_kernels(library, "fmha",
                                                 TIMED_LAUNCHES)
    tokens = BATCH * side * side
    bytes_s = 16 * tokens * c / MEMORY_BYTES_PER_S
    flops_s = 4 * tokens * n * c / F32_OPS_PER_S
    bound_ms = 1e3 * max(bytes_s, flops_s)
    out = {"shape": [BATCH, side, side, c], "heads": heads,
           "shifts": list(shifts), "heads_a_block": wa.plan(heads),
           "max_abs_err": err, "ms": time_ms(call, TIMED_LAUNCHES),
           "device_ms": device_ms, "loop_ms": loop_ms(call, TIMED_LAUNCHES),
           "host_us": host_us(call), "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_s >= flops_s else "ops",
           "flop_bound_ms": 1e3 * flops_s,
           "share_of_bound": bound_ms / device_ms,
           # the benchmark reader's count: q, k, v and out of the padded
           # windows (bench_port/attention_bytes.py)
           "padded_bound_ms": 1e3 * 16 * BATCH * pad * pad * c
           / MEMORY_BYTES_PER_S,
           "plain_ms": time_ms(plain, TIMED_PLAIN),
           "library_ms": loop_ms(library, TIMED_LAUNCHES),
           "library_device_ms": (lib_prof_ms / lib_recorded
                                 if lib_recorded else None)}
    return out


def wa_forward() -> dict:
    """Swin-T's eval forward of one 2,048-slot dispatch on the card,
    channels_last, with the kernel path and with SDPA's (the rule patched
    off): device ms of each, the kernel's launches a forward (12) and the
    largest gap between their probabilities."""
    from sykepic_tpu_torch.models import registry, swin
    from sykepic_tpu_torch.ops import window_attention as wa

    model = registry.init_weights(registry.build_model("swin_t", 50), 0)
    with torch.no_grad():  # a bias table of order 1, as a trained one
        for m in model.modules():
            if isinstance(m, swin.ShiftedWindowAttention):
                m.relative_position_bias_table.normal_()
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(BATCH, 180, 180, 3, device="cuda", generator=g).permute(
        0, 3, 1, 2)

    def forward():
        with torch.inference_mode():
            return torch.softmax(model(x) * np.log(1.3), dim=-1)

    n0 = wa.launches
    kernel = forward()
    per_forward = wa.launches - n0
    kernel_ms = loop_ms(forward, 3)
    rule = swin.ShiftedWindowAttention.kernel_runs
    swin.ShiftedWindowAttention.kernel_runs = lambda self, x: False
    try:
        n0 = wa.launches
        sdpa = forward()
        check(wa.launches == n0, "the patched rule launched the window "
              "attention kernel")
        sdpa_ms = loop_ms(forward, 3)
    finally:
        swin.ShiftedWindowAttention.kernel_runs = rule
    dp = float((kernel - sdpa).abs().max())
    check(per_forward == 12 and dp <= WA_FORWARD_TOL,
          f"swin_t forward: {per_forward} window attention launches, max "
          f"|dp| {dp}")
    return {"network": "swin_t", "launches_per_forward": per_forward,
            "max_abs_dp": dp, "kernel_ms": kernel_ms, "sdpa_ms": sdpa_ms}


def phase_kernel_window_attention(smi: str) -> dict:
    """The window-attention kernel at Swin-T's eight block shapes, and
    Swin-T's forward with it against SDPA's path; returns the forward and
    the shifted stage-1 case."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for shape in WA_SHAPES:
        cases.append(wa_case(*shape))
        torch.cuda.empty_cache()
    forward = wa_forward()
    emit({"phase": "kernel_window_attention", "gpu": smi, "cases": cases,
          "forward": forward,
          # each shape's times by its blocks a forward
          "device_ms_per_dispatch": sum(
              case["device_ms"] * n for case, n in zip(cases, WA_BLOCKS)),
          "bound_ms_per_dispatch": sum(
              case["bound_ms"] * n for case, n in zip(cases, WA_BLOCKS)),
          "padded_bound_ms_per_dispatch": sum(
              case["padded_bound_ms"] * n
              for case, n in zip(cases, WA_BLOCKS)),
          "library_device_ms_per_dispatch": sum(
              (case["library_device_ms"] or 0) * n
              for case, n in zip(cases, WA_BLOCKS))})
    torch.cuda.empty_cache()
    return {"forward": forward, **cases[1]}


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
    from sykepic_tpu_torch.ops import depthwise

    classes = checkpoint.read_class_names(model_dir)
    n_rois = sum(counts.values())
    samples = list(counts)
    runs = {}
    dw0 = depthwise.launches

    def cli(out, force):
        # python -m sykepic_tpu_torch prob, in-process, on the card
        main(["prob", "-r", str(raw), "-m", str(model_dir), "-o", str(out),
              "-b", str(BATCH)] + (["-f"] if force else []))

    def bf16(out):
        # the CLI has no dtype option: the same entry point, a bf16 model
        probability.main(samples, model_dir, out, BATCH, force=True,
                         progress_bar=False, classifier=Classifier(
                             model_dir, batch_size=BATCH, dtype="bfloat16"))

    shelf_out = WORK / "out_shelf"
    for name, env, fn in (
            ("shelf_codec_on", {}, lambda: cli(shelf_out, False)),
            ("shelf_codec_on_warm", {}, lambda: cli(shelf_out, True)),
            ("shelf_codec_off", {"SYKEPIC_WIRE_CODEC": "off"},
             lambda: cli(shelf_out, True)),
            ("shelf_bf16_codec_on", {}, lambda: bf16(shelf_out)),
            ("shelf_bf16_codec_off", {"SYKEPIC_WIRE_CODEC": "off"},
             lambda: bf16(shelf_out))):
        seconds, launches = timed_run(fn, env)
        dispatches = count_dispatches(samples)
        check_csvs(shelf_out, counts, classes)
        check(launches == dispatches,
              f"{name}: K1 launched {launches} times for {dispatches} dispatches")
        runs[name] = {"seconds": seconds, "rois_per_s": n_rois / seconds,
                      "dispatches": dispatches, "k1_launches": launches}
    # ResNet18 has no depthwise convolution
    check(depthwise.launches == dw0, "ResNet18's prob launched the "
          "depthwise kernel")
    emit({"phase": "prob", "rois": n_rois, "samples": len(samples),
          "batch": BATCH, "runs": runs,
          "depthwise_launches": depthwise.launches - dw0})

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
          "mean_top_prob": float(pg.max(1).mean())})
    emit({"phase": "bf16_contract", **bf16_contract(pg, pb)})
    return runs["shelf_codec_on"]["k1_launches"]


def bf16_contract(p32: np.ndarray, p16: np.ndarray) -> dict:
    """The card's bfloat16 rows against its float32 rows for the same ROIs:
    the argmax agrees on every ROI whose float32 top-two gap exceeds twice
    ``BF16_DRIFT_BOUND`` (bf16 can move a probability by at most the bound,
    so only a nearer tie may flip), and no probability moves further than
    the bound."""
    top2 = np.sort(p32, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * BF16_DRIFT_BOUND
    agree = p32.argmax(1) == p16.argmax(1)
    drift = float(np.abs(p16 - p32).max())
    check(agree[clear].all(), f"bf16 flipped the argmax of "
          f"{int((~agree[clear]).sum())} ROIs whose f32 top-two gap exceeds "
          f"{2 * BF16_DRIFT_BOUND}")
    check(drift <= BF16_DRIFT_BOUND,
          f"bf16 max |dp| {drift} > {BF16_DRIFT_BOUND}")
    return {"rois": len(p32), "drift_bound": BF16_DRIFT_BOUND,
            "max_abs_dp": drift, "near_ties": int((~clear).sum()),
            "argmax_agree_clear": float(agree[clear].mean()),
            "argmax_agree_all": float(agree.mean())}


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

    # device time per kernel the trace holds, times the kernels a call
    # launches (the counters), so a trace that misses records reads right
    launched = sum(flood_counts().values())
    prof_ms, recorded = profiled_kernels(call, "flood_", TIMED_LAUNCHES)
    per_call = (sum(flood_counts().values()) - launched) / (TIMED_LAUNCHES
                                                            + 1)
    out = {"phase": "kernel_flood", "case": name, "shape": [b, h, w],
           "cap": cap, "form": used,
           "instance": flood.pick_form(h, w, flood.smem_limit(seed.device))
           if used == "warp" else used,
           "max_abs_err": float(diff),
           "steps_max": int(steps.max()) if b else 0,
           "steps_mean": float(steps.float().mean()) if b else 0.0,
           "ms": time_ms(call, TIMED_LAUNCHES),
           # the kernels' own device time, without the wrapper's host time
           # None: the trace holds none of the kernels the calls launched
           "device_ms": (0.0 if per_call == 0 else
                         prof_ms / recorded * per_call if recorded else None),
           "device_kernels_recorded": recorded,
           "device_kernels_launched": per_call * TIMED_LAUNCHES,
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
             for k in ("ms", "host_us", "plain_ms", "bytes_ms", "ops_ms")}
    device = [c["device_ms"] for c in cases]
    total["device_ms"] = None if None in device else sum(device)
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


# device time by kind for inference profiles: the first matching word of
# each kernel's name
INFER_KINDS = (("K1", ("resize_pad",)), ("K2", ("flood_",)),
               ("cuFFT", ("fft",)),
               ("cuDNN/cuBLAS", ("xmma", "convolve", "cudnn", "gemm")),
               ("max_pool", ("max_pool",)), ("reduce", ("reduce",)),
               ("sort", ("sort", "radix")), ("elementwise", ("elementwise",)),
               ("copy/fill", ("Memcpy", "Memset", "copy")))
# and for a training epoch
TRAIN_KINDS = (("K1", ("resize_pad",)),
               ("conv/gemm backward", ("dgrad", "wgrad", "bwd", "backward")),
               ("conv/gemm forward", ("fprop", "fwd", "xmma", "convolve",
                                      "cudnn", "gemm", "cutlass")),
               ("batch_norm", ("batch_norm", "bn_")),
               ("optimizer", ("multi_tensor_apply", "foreach")),
               ("max_pool", ("max_pool",)), ("reduce", ("reduce",)),
               ("elementwise", ("elementwise",)),
               ("copy/fill", ("Memcpy", "Memset", "copy")))


def device_profile(run, kinds=INFER_KINDS) -> dict:
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


# -- training -------------------------------------------------------------------

TRAIN_CLASSES = 8
TRAIN_IMAGES = 3000
TRAIN_EPOCHS = 4
TRAIN_SLOTS = 2048  # slots of the K1 train-form case
STEP_IMAGES = 32  # images of the card-against-CPU train step
# sd of the noise on log area when the train set's shapes are dealt out to
# the classes: sizes follow the class, neighbouring classes overlap
TRAIN_SIZE_NOISE = 0.35
DECODE_FILES = 200  # files of each filter kind in the single-thread decode
TRAIN_INI = """
[dataset]
path = {dataset}
split = 0.8, 0.1, 0.1
external_test =
min_N =
max_N =
exclude =
random_seed = 24
oversample_until =
oversample_with_decay =

[model]
path = {models}
network = resnet18
weights =
id = auto
exist_ok = no
head = 256, 128
dropout =

[image]
shape = 3, 180, 180
augmentations = flip, translate, zoom, brightness
imagenet_normalization = no
border = mode
zoom_range = 0.6, 1.4
brightness_range = 0.95, 1.1
max_rotation = 10
batch_size = 256
num_workers = 8
device_cache = auto

[train]
max_epochs = {epochs}
early_stop_patience = 12
learning_rate = 0.01
optimizer = Adam
dtype = bfloat16

[lr_warmup]
use = yes
factor_1 = 0.1
factor_2 = 0.5
step_1 = 1
step_2 = 2
step_3 = 3

[lr_reduction]
use = yes
factor = 0.1
patience = 4
"""
TRAIN_ARTIFACTS = ("config.ini", "class_names.txt", "class_distribution.csv",
                   "best_state.msgpack", "train_state.pt", "test_report.txt")
STEP_LOSS_RTOL = 1e-4
STEP_VAR_RTOL = 1e-3


def build_train_set(root: Path, seed: int) -> Path:
    """``TRAIN_IMAGES`` PNGs in ``TRAIN_CLASSES`` class folders, written
    with the port's PNG writer. The shapes are drawn from ``ROI_SIZE_MIX``
    (bench.py's IFCB size mix, as the ``prob`` workload's), ordered by log
    area plus noise and dealt out to the classes in that order, so ROI size
    follows the class as in plankton data while the set keeps the mix
    (1% wider than the 180 px input, so the host pre-shrink runs). Each
    class's mean gray level rises with it. Every other file cycles its rows
    through the Sub, Up, Average and Paeth filters (``*_m.png``), as
    libpng's adaptive choice does; the rest take filter 0 (``*_0.png``)."""
    from sykepic_tpu_torch.utils import png

    rng = np.random.default_rng(seed)
    shapes = roi_shapes(rng, TRAIN_IMAGES)
    key = np.log([h * w for h, w in shapes]) + rng.normal(
        0, TRAIN_SIZE_NOISE, len(shapes))
    order = np.argsort(key, kind="stable")
    per = TRAIN_IMAGES // TRAIN_CLASSES
    for k in range(TRAIN_CLASSES):
        d = root / f"class_{k}"
        d.mkdir(parents=True)
        for i, j in enumerate(order[k * per:(k + 1) * per]):
            h, w = shapes[j]
            img = rng.normal(40 + 24 * k, 20, (h, w))
            img[::3] += 30 * (k % 2)  # stripes on odd classes
            mixed = i % 2 == 1
            png.write_png(d / f"{k}_{i:04}_{'m' if mixed else '0'}.png",
                          np.clip(img, 0, 255).astype(np.uint8), level=1,
                          filters=(1, 2, 3, 4) if mixed else (0,))
    return root


def decode_case(paths, reps: int = 3) -> dict:
    """Single-threaded decode of ``paths``: us an image (and per megapixel)
    to read the files' bytes, and to decode those bytes with the native
    unfilter and with its Python twin."""
    from sykepic_tpu_torch.ingest import native
    from sykepic_tpu_torch.utils import png

    pixels = sum(h * w for h, w in map(png.png_dims, paths))
    t0 = time.perf_counter()
    blobs = [Path(p).read_bytes() for p in paths]
    out = {"files": len(paths), "pixels": pixels,
           "read_us_per_image": 1e6 * (time.perf_counter() - t0) / len(paths)}
    orig = native.png_unfilter
    for tag, n in (("native", reps), ("python", 1)):
        if tag == "python":
            native.png_unfilter = lambda rows, bpp: None
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                for p, b in zip(paths, blobs):
                    png.decode_png(b, p)
            s = (time.perf_counter() - t0) / n
        finally:
            native.png_unfilter = orig
        out[tag] = {"us_per_image": 1e6 * s / len(paths),
                    "us_per_mpixel": 1e12 * s / pixels}
    return out


def k1_step_check(calls) -> dict:
    """Every K1 train-form launch of one mixed step of the training run,
    recorded as ``Trainer._preprocess`` made it (its store, rows' metadata,
    affine, brightness, output dtype and output), against the plain
    version: the step's own bfloat16 outputs within one bf16 ulp, and the
    same inputs through the kernel in float32 within 1e-3/255."""
    from sykepic_tpu_torch.ops import preprocess, resize_pad

    cases = []
    for c in calls:
        kw = {k: c[k] for k in ("affine", "bright", "mean", "std")}
        args = (c["pixels"], c["meta"], *c["shape"])
        plain = preprocess.resize_pad_plain(*args, torch.float32, **kw)
        got = c["out"]
        err = (got.float() - plain.to(got.dtype).float()).abs()
        if got.dtype == torch.bfloat16:
            ulp = plain.to(got.dtype).float().abs() * 2.0 ** -7
            check(bool((err <= ulp).all()),
                  f"K1 train form, step bucket {list(c['pixels'].shape)}: "
                  "beyond 1 bf16 ulp")
        f32 = resize_pad.resize_pad(*args, torch.float32, **kw)
        err32 = float((f32 - plain).abs().max())
        check(err32 <= 1e-3 / 255,
              f"K1 train form f32, step bucket {list(c['pixels'].shape)}: "
              f"max |diff| {err32}")
        cases.append({"store": list(c["pixels"].shape),
                      "slots": int(c["meta"].shape[1]),
                      "dtype": str(got.dtype).replace("torch.", ""),
                      "max_abs_err": float(err.max()),
                      "max_abs_err_f32": err32})
    return {"buckets": len(cases), "cases": cases,
            "max_abs_err_f32": max(c["max_abs_err_f32"] for c in cases)}


def phase_train(smi: str) -> dict:
    """The train path through the CLI; returns what the later phases and
    the kernels line read."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.models import checkpoint
    from sykepic_tpu_torch.ops import resize_pad
    from sykepic_tpu_torch.train import device_data
    from sykepic_tpu_torch.train import input as input_mod
    from sykepic_tpu_torch.train import trainer as trainer_mod

    root = WORK / "train"
    t0 = time.perf_counter()
    dataset = build_train_set(root / "dataset", seed=11)
    write_s = time.perf_counter() - t0
    ini = root / "train.ini"
    ini.write_text(TRAIN_INI.format(dataset=dataset, models=root / "models",
                                    epochs=TRAIN_EPOCHS))
    epochs, evals, last, step_calls, setups = [], [0], {}, [], []
    decode = {"0": [0, 0.0], "m": [0, 0.0]}  # files, thread-seconds
    lock = threading.Lock()
    Trainer = trainer_mod.Trainer
    Dataset = device_data.DeviceDataset
    orig = (Trainer.train_epoch_mixed, Trainer._eval, Trainer._step,
            Dataset.__init__, input_mod.read_image, resize_pad.resize_pad)
    orig_epoch, orig_eval, orig_step, orig_init, orig_read, orig_k1 = orig

    def epoch(self, stores, idxs, wts, stage, lrs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_epoch(self, stores, idxs, wts, stage, lrs)
        loss_sum, correct, n = (float(v) for v in out)  # synchronises
        epochs.append({"stage": stage, "lrs": list(lrs),
                       "seconds": time.perf_counter() - t0,
                       "steps": int(wts.shape[0]), "buckets": len(stores),
                       "slots": int(wts.size), "images": n,
                       "loss": loss_sum / n, "acc": correct / n})
        last.update(trainer=self, args=(stores, idxs, wts, stage, lrs))
        return out

    def count_eval(self, parts, wts):
        evals[0] += len(parts)
        return orig_eval(self, parts, wts)

    def record_k1(pixels, meta, th, tw, c, dtype, **kw):
        # the main path's own launch; its inputs and output kept for later
        out = orig_k1(pixels, meta, th, tw, c, dtype, **kw)
        if kw.get("affine") is not None:
            step_calls.append({
                "pixels": pixels, "meta": meta.clone(), "shape": (th, tw, c),
                "out": out.clone(),
                **{k: None if kw.get(k) is None else kw[k].clone()
                   for k in ("affine", "bright", "mean", "std")}})
        return out

    def first_step(self, parts, wts, stage, lrs):
        if step_calls:
            return orig_step(self, parts, wts, stage, lrs)
        resize_pad.resize_pad = record_k1
        try:
            return orig_step(self, parts, wts, stage, lrs)
        finally:
            resize_pad.resize_pad = orig_k1

    def timed_read(path):
        t = time.perf_counter()
        img = orig_read(path)
        t = time.perf_counter() - t
        with lock:
            d = decode[Path(path).stem[-1]]
            d[0] += 1
            d[1] += t
        return img

    def timed_init(self, paths, *args, **kwargs):
        t = time.perf_counter()
        orig_init(self, paths, *args, **kwargs)
        setups.append({"files": len(paths), "rows": self.num_rows,
                       "bytes": self.nbytes,
                       "seconds": time.perf_counter() - t})

    (Trainer.train_epoch_mixed, Trainer._eval, Trainer._step,
     Dataset.__init__, input_mod.read_image) = (epoch, count_eval, first_step,
                                                timed_init, timed_read)
    try:
        resize_pad.launches = resize_pad.train_launches = 0
        t0 = time.perf_counter()
        model_dir = main(["train", str(ini)])  # the card: the default device
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"train": resize_pad.train_launches,
                    "eval": resize_pad.launches}
    finally:
        (Trainer.train_epoch_mixed, Trainer._eval, Trainer._step,
         Dataset.__init__, input_mod.read_image,
         resize_pad.resize_pad) = orig

    check(len(epochs) == TRAIN_EPOCHS,
          f"{len(epochs)} whole-epoch calls for {TRAIN_EPOCHS} epochs")
    check([e["stage"] for e in epochs] == [0, 1, 2, 2],
          f"stages {[e['stage'] for e in epochs]}")
    losses = [e["loss"] for e in epochs]
    check(all(np.isfinite(losses)), f"train losses {losses}")
    check(losses[-1] < losses[0], f"the train loss did not fall: {losses}")
    want = sum(e["buckets"] * e["steps"] for e in epochs)
    check(launches["train"] == want,
          f"K1's train form launched {launches['train']} times for {want} "
          "bucket-steps")
    check(launches["eval"] == evals[0] and evals[0] > 0,
          f"K1's eval form launched {launches['eval']} times for "
          f"{evals[0]} eval batches")
    # after the counts were read: these comparison launches count nowhere
    check(len(step_calls) == epochs[0]["buckets"],
          f"recorded {len(step_calls)} K1 launches of the first step for "
          f"{epochs[0]['buckets']} buckets")
    step_k1 = k1_step_check(step_calls)
    missing = [f for f in TRAIN_ARTIFACTS if not (model_dir / f).is_file()]
    check(not missing, f"the model directory lacks {missing}")
    classes = checkpoint.read_class_names(model_dir)
    check(len(classes) == TRAIN_CLASSES, f"classes {classes}")
    rng = np.random.default_rng(5)
    by_kind = {k: sorted(dataset.rglob(f"*_{k}.png")) for k in decode}
    single = {k: decode_case([v[int(i)] for i in rng.choice(
        len(v), DECODE_FILES, replace=False)]) for k, v in by_kind.items()}

    # the trained directory through the port's prob on the card
    out = WORK / "out_trained"
    n_fixture = len(fixture_images())
    main(["prob", "-r", str(FIXTURE.parent), "-m", str(model_dir), "-o",
          str(out), "-b", "256"])
    check_csvs(out, {FIXTURE: n_fixture}, classes)

    warm = epochs[1:]
    warm_s = sum(e["seconds"] for e in warm)
    trainer, args = last["trainer"], last["args"]
    profile = device_profile(lambda: trainer.train_epoch_mixed(*args),
                             kinds=TRAIN_KINDS)
    k1_share = profile["k1_share_of_device"]
    out = {"phase": "train", "gpu": smi, "images": TRAIN_IMAGES,
           "classes": TRAIN_CLASSES, "batch": 256, "dtype": "bfloat16",
           "seconds": seconds, "epochs": epochs,
           "set_up": {"write_pngs_s": write_s, "datasets": setups,
                      # summed over the decode threads, by row filters
                      "decode": {
                          k: {"files": n, "thread_s": t,
                              "us_per_image": 1e6 * t / max(n, 1)}
                          for k, (n, t) in decode.items()},
                      "decode_single_thread": single},
           "k1_step_check": step_k1,
           "launches": launches, "expected_train_launches": want,
           "eval_batches": evals[0],
           "warm_images_per_s": sum(e["images"] for e in warm) / warm_s,
           "warm_slots_per_s": sum(e["slots"] for e in warm) / warm_s,
           "warm_step_ms": 1e3 * warm_s / sum(e["steps"] for e in warm),
           "profiled_epoch": {"steps": int(args[2].shape[0]),
                              "k1_share_of_device": k1_share,
                              **{k: v for k, v in profile.items()
                                 if not k.startswith("k2")}},
           "model_dir_files": sorted(f.name for f in model_dir.iterdir())}
    emit(out)
    return {"launches": launches, "trainer": trainer, "args": args,
            "dataset": dataset, "model_dir": model_dir, "step_k1": step_k1}


def train_form_inputs(stores, idxs, slots: int = 2048, seed: int = 9):
    """K1 train-form inputs on ``slots`` slots of the largest of
    ``stores`` (its rows in ``idxs``, repeated): random affines with both
    flips, zoom 0.6 and 1.4, translations at -limit and +limit, and
    brightness in [0.95, 1.1]. Returns the store's pixels, the slots'
    metadata, affine and brightness, the bytes a call must read (each
    stored ROI the slots read, once, and the slots' own inputs) and the
    pixels inside the slots' resized ROIs."""
    from sykepic_tpu_torch.ops import augment

    k = max(range(len(stores)), key=lambda i: stores[i]["canvas"][0].numel())
    store = stores[k]
    rows = np.unique(idxs[k])
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.choice(rows, slots)).to(
        store["canvas"].device)
    meta = store["meta"].index_select(1, idx).contiguous()
    lim = store["lim"].index_select(1, idx).float()
    r = slots
    dev = meta.device

    def sign():
        return torch.from_numpy(rng.choice([-1.0, 1.0], r).astype(
            np.float32)).to(dev)

    draws = augment.Draws(
        torch.from_numpy(rng.random(r) < 0.5).to(dev),
        torch.from_numpy(rng.random(r) < 0.5).to(dev),
        sign() * lim[0], sign() * lim[1],
        torch.from_numpy(rng.choice([0.6, 1.4], r).astype(np.float32)).to(dev),
        torch.from_numpy(rng.uniform(0.95, 1.1, r).astype(np.float32)).to(dev))
    affine = augment.affine_rows(draws, 180, 180)
    m = meta.cpu().numpy().astype(np.int64)
    _, first = np.unique(m[0], return_index=True)
    read = int((m[3][first] * m[4][first]).sum()) + meta.nbytes + \
        affine.nbytes
    return {"pixels": store["canvas"], "meta": meta, "affine": affine,
            "bright": draws.bright, "read": read,
            "inside": int((m[5] * m[6]).sum())}


# K1's train-form cases: float32 and bfloat16 (what training stores under
# [train] dtype = bfloat16), brightness (the level table) on and off
TRAIN_FORM_CASES = (("bright_on", True, torch.float32),
                    ("bright_off", False, torch.float32),
                    ("bright_on_bf16", True, torch.bfloat16),
                    ("bright_off_bf16", False, torch.bfloat16))


def phase_kernel_train(run: dict) -> dict:
    """K1's train form against its plain version on ``TRAIN_SLOTS`` slots
    of the largest store of the training run (rows of its last epoch,
    repeated): float32 and bfloat16, each with brightness on and off;
    returns the cases by name."""
    from sykepic_tpu_torch.ops import preprocess, resize_pad

    inp = train_form_inputs(run["args"][0], run["args"][1], TRAIN_SLOTS)
    pix, meta, affine = inp["pixels"], inp["meta"], inp["affine"]
    r = TRAIN_SLOTS
    cases = {}
    for tag, on, dtype in TRAIN_FORM_CASES:
        bright = inp["bright"] if on else None

        def call(out=None, bright=bright, dtype=dtype):
            return resize_pad.resize_pad(pix, meta, 180, 180, 3, dtype,
                                         affine=affine, bright=bright,
                                         out=out)

        def plain(bright=bright, dtype=dtype):
            return preprocess.resize_pad_plain(pix, meta, 180, 180, 3, dtype,
                                               affine=affine, bright=bright)

        before = resize_pad.train_launches
        got = call()
        torch.cuda.synchronize()
        check(resize_pad.train_launches == before + 1,
              "K1's train form did not launch")
        check(got.dtype == dtype, f"K1 train form {tag}: {got.dtype}")
        want = preprocess.resize_pad_plain(pix, meta, 180, 180, 3,
                                           affine=affine, bright=bright)
        diff = (got.float() - want.to(dtype).float()).abs()
        err = float(diff.max())
        if dtype == torch.float32:
            check(err <= 1e-3 / 255, f"K1 train form {tag}: max |diff| {err}")
        else:  # one bf16 ulp of the plain version cast to bf16
            ulp = want.to(dtype).float().abs() * 2.0 ** -7
            check(bool((diff <= ulp).all()),
                  f"K1 train form {tag}: beyond one bf16 ulp")
        out = torch.empty_like(got)
        written = got.numel() * got.element_size()
        nbytes = inp["read"] + written + (
            0 if bright is None else bright.nbytes)
        bytes_s = nbytes / MEMORY_BYTES_PER_S
        ops_s = inp["inside"] * 3 * K1_OPS_PER_PIXEL / F32_OPS_PER_S
        bound_ms = 1e3 * max(bytes_s, ops_s)
        cases[tag] = {
            "max_abs_err": err,
            **k1_timings(call, got, bound_ms),
            # back to back into one preallocated output: no allocation
            "loop_ms_out": loop_ms(lambda: call(out), TIMED_LAUNCHES),
            "plain_ms": time_ms(plain, TIMED_PLAIN),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bytes": nbytes}
    emit({"phase": "kernel_resize_pad_train", "slots": r,
          "store": list(pix.shape), **cases})
    return cases


def phase_train_step_compare(run: dict) -> None:
    """One float32 train step of the full-width model on the card and on
    the CPU, from the same weights and batch (no augmentation, no
    dropout)."""
    import copy

    from sykepic_tpu_torch.ingest import pack
    from sykepic_tpu_torch.models import registry
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.input import HostBatch
    from sykepic_tpu_torch.train.trainer import Trainer
    from sykepic_tpu_torch.utils import png

    paths = sorted(run["dataset"].rglob("*.png"))
    rng = np.random.default_rng(4)
    picks = [paths[int(i)] for i in rng.choice(len(paths), STEP_IMAGES,
                                               replace=False)]
    imgs = [pack.pre_shrink(png.read_png(p), 180, 180) for p in picks]
    bh, bw = pack.bucket_for(max(i.shape[0] for i in imgs),
                             max(i.shape[1] for i in imgs),
                             pack.DEFAULT_BUCKETS)
    canvas = np.zeros((len(imgs), bh, bw), np.uint8)
    for j, img in enumerate(imgs):
        canvas[j, :img.shape[0], :img.shape[1]] = img
    labels = np.array([int(p.parent.name.split("_")[1]) for p in picks],
                      np.int32)
    batch = HostBatch(canvas, np.array([i.shape[0] for i in imgs], np.int32),
                      np.array([i.shape[1] for i in imgs], np.int32),
                      labels, np.ones(len(imgs), np.float32), picks)
    spec = PreprocessSpec(180, 180, 3, border="mode")
    model = registry.init_weights(registry.build_model(
        "resnet18", TRAIN_CLASSES, head=(256, 128)), seed=1)
    lrs = (1e-3, 1e-4, 1e-5)
    out = {}
    for where, m in (("cpu", copy.deepcopy(model)), ("cuda", model)):
        t = Trainer(m, optimizer="Adam", preprocess_spec=spec, device=where,
                    dtype="float32")
        t0 = time.perf_counter()
        loss, _, n = t.train_batch(batch, 2, lrs)
        loss = float(loss) / float(n)
        out[where] = {"loss": loss, "seconds": time.perf_counter() - t0,
                      "state": {k: v.detach().cpu() for k, v in
                                t.model.state_dict().items()}}
    rel_loss = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(
        out["cpu"]["loss"])
    var_rel = max(float(((out["cuda"]["state"][k] - v).abs()
                         / v.abs()).max())
                  for k, v in out["cpu"]["state"].items()
                  if k.endswith("running_var"))
    emit({"phase": "train_step_card_vs_cpu", "images": STEP_IMAGES,
          "canvas": [bh, bw], "loss_cpu": out["cpu"]["loss"],
          "loss_card": out["cuda"]["loss"], "loss_rel_diff": rel_loss,
          "running_var_max_rel_diff": var_rel,
          "seconds_cpu": out["cpu"]["seconds"],
          "seconds_card": out["cuda"]["seconds"]})
    check(rel_loss <= STEP_LOSS_RTOL, f"train step loss differs: {rel_loss}")
    check(var_rel <= STEP_VAR_RTOL,
          f"train step running_var differs: {var_rel}")


# -- the other model families -------------------------------------------------

FAMILY_NETS = ("efficientnet_b0", "efficientnet_v2_s", "mobilenet_v3_large",
               "vgg16_bn", "alexnet", "convnext_tiny", "regnet_y_400mf",
               "swin_t")
# eval LayerNorm and window-attention kernel launches a forward of each
# family that takes them (Swin-T: the patch embedding's, two a block, four
# patch mergings and the last; one attention a block)
LN_PER_FORWARD = {"convnext_tiny": 22, "swin_t": 29}
WA_PER_FORWARD = {"swin_t": 12}
FAMILY_ROIS = 4000
FAMILY_COMPARE = 64  # ROIs of each family's card-against-CPU comparison
FAMILY_TRAIN = (
    ("efficientnet_b0", "flip, translate, zoom, rotate, brightness"),
    ("convnext_tiny", "flip, translate, zoom, brightness"))
FAMILY_TRAIN_EPOCHS = 2  # warmup steps 1/2: stages 0 then 1


def build_family_dir(root: Path, name: str) -> Path:
    """The repo's full-width config (3x180x180, head 256,128, 50 classes)
    with ``network = name``: weights from the port's seeded init, random
    BatchNorm running statistics (ConvNeXt: ``layer_scale`` of order 0.1
    instead of its 1e-6 init, so that its blocks count), the last head
    layer scaled so that the logits of random images spread with a
    standard deviation of 8, 2.1 after ``prob``'s ``ln(1.3)`` temperature
    (at the init's scale every family's probabilities were near 1/50, and
    the card-against-CPU argmax check near empty), written as
    ``best_state.msgpack`` by the port's writer (Swin, which has no Flax
    form: ``best_state.pth``)."""
    from sykepic_tpu_torch.models import checkpoint, registry
    from sykepic_tpu_torch.models.convnext import CNBlock
    from sykepic_tpu_torch.models.resnet import BatchNorm2d
    from sykepic_tpu_torch.train import config as tcfg

    d = root / name
    d.mkdir(parents=True)
    shutil.copy(MODEL_SRC / "class_names.txt", d)
    text = (MODEL_SRC / "config.ini").read_text()
    check("network = resnet18" in text, "the model config names no network")
    (d / "config.ini").write_text(text.replace("network = resnet18",
                                               f"network = {name}"))
    model, _ = tcfg.get_network(tcfg.read_config(d / "config.ini"),
                                len(checkpoint.read_class_names(d)))
    registry.init_weights(model, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=g) * 0.05)
                m.running_var.copy_(0.75 + 0.5 * torch.rand(
                    m.num_features, generator=g))
            elif isinstance(m, CNBlock):
                m.layer_scale.copy_(0.05 + 0.1 * torch.rand(
                    m.layer_scale.shape, generator=g))
        logits = model.eval()(torch.rand(8, 3, 180, 180, generator=g))
        model.head[-1].weight.mul_(8.0 / float(logits.std()))
    if name.startswith("swin"):  # no Flax form: torchvision's keys
        torch.save(model.state_dict(), d / checkpoint.TORCH_STATE)
    else:
        checkpoint.save_variables(d / checkpoint.BEST_STATE,
                                  checkpoint.to_flax_variables(
                                      model.state_dict(), name))
    return d


def top_kinds(profile: dict, n: int = 3) -> list:
    kinds = sorted(profile["device_ms_by_kind"].items(), key=lambda kv: -kv[1])
    return [{"kind": k, "ms": ms} for k, ms in kinds[:n]]


def family_prob(name: str, raw: Path, counts: dict, small: list,
                smi: str) -> tuple[int, int, int, int]:
    """One family's model dir through ``prob`` on the card (cold, then
    warm), a profiled warm stream, and the card against
    the CPU; returns K1's, the LayerNorm kernel's, the depthwise
    kernel's and the window-attention kernel's launches in the cold run."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.compute.engine import Classifier
    from sykepic_tpu_torch.models import checkpoint
    from sykepic_tpu_torch.ops import depthwise, layernorm
    from sykepic_tpu_torch.ops import window_attention as wa

    model_dir = build_family_dir(WORK / "families", name)
    classes = checkpoint.read_class_names(model_dir)
    samples = list(counts)
    n_rois = sum(counts.values())
    out = WORK / "out_families" / name

    def cli(force):
        main(["prob", "-r", str(raw), "-m", str(model_dir), "-o", str(out),
              "-b", str(BATCH)] + (["-f"] if force else []))

    ln0, dw0 = layernorm.launches, depthwise.launches
    wa.launches = 0
    cold_s, launches = timed_run(lambda: cli(False), {})
    ln_launches = layernorm.launches - ln0
    dw_launches = depthwise.launches - dw0
    wa_launches = wa.launches
    dispatches = count_dispatches(samples)
    check_csvs(out, counts, classes)
    check(launches == dispatches and launches > 0,
          f"{name}: K1 launched {launches} times for {dispatches} dispatches")
    ln_want = LN_PER_FORWARD.get(name, 0) * dispatches
    check(ln_launches == ln_want, f"{name}: the LayerNorm kernel launched "
          f"{ln_launches} times for {ln_want}")
    wa_want = WA_PER_FORWARD.get(name, 0) * dispatches
    check(wa_launches == wa_want, f"{name}: the window-attention kernel "
          f"launched {wa_launches} times for {wa_want}")
    dw_want = DW_PER_FORWARD.get(name, 0) * dispatches
    check(dw_launches == dw_want, f"{name}: the depthwise kernel launched "
          f"{dw_launches} times for {dw_want}")
    warm_s, _ = timed_run(lambda: cli(True), {})
    check_csvs(out, counts, classes)

    clf = Classifier(model_dir, batch_size=BATCH)

    def stream():
        for _ in clf.classify_blocks(sample_blocks(samples)):
            pass

    profile = device_profile(stream)

    cpu = classify(Classifier(model_dir, batch_size=BATCH, device="cpu"),
                   small)
    card = classify(clf, small)
    check(cpu.keys() == card.keys(), f"{name}: ROI sets differ")
    keys = sorted(cpu)
    pc = np.stack([cpu[k] for k in keys])
    pg = np.stack([card[k] for k in keys])
    top2 = np.sort(pc, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * PROB_BOUND
    diff = float(np.abs(pc - pg).max())
    check(diff <= PROB_BOUND, f"{name} card vs CPU: max |dp| {diff}")
    check((pc.argmax(1) == pg.argmax(1))[clear].all(),
          f"{name} card vs CPU: argmax differs")
    emit({"phase": "families_prob", "network": name, "gpu": smi,
          "rois": n_rois, "dispatches": dispatches, "k1_launches": launches,
          "layernorm_launches": ln_launches,
          "depthwise_launches": dw_launches,
          "window_attention_launches": wa_launches,
          "cold_s": cold_s, "warm_s": warm_s,
          "warm_e2e_rois_per_s": n_rois / warm_s,
          "device_busy_share": profile["device_busy_share"],
          "k1_share_of_device": profile["k1_share_of_device"],
          "top_device_kinds": top_kinds(profile),
          "card_vs_cpu": {"rois": len(keys), "max_abs_dp": diff,
                          "argmax_agree": float(
                              (pc.argmax(1) == pg.argmax(1)).mean()),
                          "ties_within_two_quanta": int((~clear).sum()),
                          "mean_top_prob": float(pc.max(1).mean())}})
    return launches, ln_launches, dw_launches, wa_launches


def family_train(name: str, augmentations: str, dataset: Path,
                 smi: str) -> dict:
    """``train`` at full width on the train phase's set for two epochs
    (stages 0 and 1); returns K1's launches by form."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.models import checkpoint
    from sykepic_tpu_torch.ops import resize_pad
    from sykepic_tpu_torch.train import trainer as trainer_mod

    root = WORK / "families_train" / name
    root.mkdir(parents=True)
    ini = root / "train.ini"
    text = TRAIN_INI.format(dataset=dataset, models=root / "models",
                            epochs=FAMILY_TRAIN_EPOCHS)
    text = text.replace("network = resnet18", f"network = {name}").replace(
        "augmentations = flip, translate, zoom, brightness",
        f"augmentations = {augmentations}")
    ini.write_text(text)
    epochs, last, evals = [], {}, [0]
    Trainer = trainer_mod.Trainer
    orig, orig_eval = Trainer.train_epoch_mixed, Trainer._eval

    def epoch(self, stores, idxs, wts, stage, lrs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, stores, idxs, wts, stage, lrs)
        loss_sum, _, n = (float(v) for v in out)
        epochs.append({"stage": stage, "seconds": time.perf_counter() - t0,
                       "steps": int(wts.shape[0]), "buckets": len(stores),
                       "images": n, "loss": loss_sum / n})
        last.update(trainer=self, args=(stores, idxs, wts, stage, lrs))
        return out

    def count_eval(self, parts, wts):
        evals[0] += len(parts)
        return orig_eval(self, parts, wts)

    Trainer.train_epoch_mixed, Trainer._eval = epoch, count_eval
    try:
        resize_pad.launches = resize_pad.train_launches = 0
        t0 = time.perf_counter()
        model_dir = main(["train", str(ini)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"eval_form": resize_pad.launches,
                    "train_form": resize_pad.train_launches}
    finally:
        Trainer.train_epoch_mixed, Trainer._eval = orig, orig_eval
    check([e["stage"] for e in epochs] == [0, 1],
          f"{name}: stages {[e['stage'] for e in epochs]}")
    losses = [e["loss"] for e in epochs]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{name}: train losses {losses}")
    bucket_steps = sum(e["buckets"] * e["steps"] for e in epochs)
    # the rotation route resizes with K1's eval form (0-255 scale), one
    # launch per bucket and step, beside the eval batches' launches
    if "rotate" in augmentations:
        want = {"eval_form": bucket_steps + evals[0], "train_form": 0}
    else:
        want = {"eval_form": evals[0], "train_form": bucket_steps}
    check(launches == want and evals[0] > 0,
          f"{name}: K1 launched {launches} for {want}")
    out = WORK / "out_families_trained" / name
    main(["prob", "-r", str(FIXTURE.parent), "-m", str(model_dir), "-o",
          str(out), "-b", "256"])
    check_csvs(out, {FIXTURE: len(fixture_images())},
               checkpoint.read_class_names(model_dir))
    # one more epoch on the last epoch's plan, timed alone, then one under
    # the profiler: epoch 2 was stage 1's first and carried its warm-up
    trainer, args = last["trainer"], last["args"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steady = float(trainer.train_epoch_mixed(*args)[2])
    steady_s = time.perf_counter() - t0
    profile = device_profile(lambda: trainer.train_epoch_mixed(*args),
                             kinds=TRAIN_KINDS)
    warm = epochs[1]
    emit({"phase": "families_train", "network": name, "gpu": smi,
          "augmentations": augmentations, "batch": 256, "dtype": "bfloat16",
          "seconds": seconds, "epochs": epochs, "launches": launches,
          "bucket_steps": bucket_steps, "eval_batches": evals[0],
          "epoch_2_images_per_s": warm["images"] / warm["seconds"],
          "steady_epoch_s": steady_s,
          "warm_images_per_s": steady / steady_s,
          "profiled_epoch": {
              "steps": int(args[2].shape[0]),
              "wall_ms": profile["wall_ms"],
              "device_busy_ms": profile["device_busy_ms"],
              "device_busy_share": profile["device_busy_share"],
              "k1_share_of_device": profile["k1_share_of_device"],
              "device_ms_by_kind": profile["device_ms_by_kind"],
              "top": profile["top"][:5]}})
    return launches


def phase_families(run: dict, smi: str) -> dict:
    """The eight families through ``prob`` and two through ``train``;
    returns K1's launches of each family's ``prob`` run and train run, and
    the LayerNorm, depthwise and window-attention kernels' of each ``prob``
    run."""
    raw = WORK / "raw_families"
    counts = build_raw(raw, FAMILY_ROIS, seed=43, start=datetime(2020, 1, 1))
    small = list(build_raw(WORK / "raw_families_compare", FAMILY_COMPARE,
                           seed=8, start=datetime(2020, 6, 1)))
    launched = {name: family_prob(name, raw, counts, small, smi)
                for name in FAMILY_NETS}
    train = {name: family_train(name, augs, run["dataset"], smi)
             for name, augs in FAMILY_TRAIN}
    return {"prob": {name: n[0] for name, n in launched.items()},
            "layernorm": {name: n[1] for name, n in launched.items()},
            "depthwise": {name: n[2] for name, n in launched.items()},
            "window_attention": {name: n[3] for name, n in launched.items()},
            "train": train}


# -- multi-GPU: the data-parallel trainer and the engine under a mesh ----------

PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_LRS = (1e-3, 1e-4, 1e-5)


def _epochs(trainer, plans) -> list:
    """Whole-epoch calls over ``plans`` (stage 2); loss, seconds, steps."""
    out = []
    for stores, idxs, wts in plans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ls, _, n = trainer.train_epoch_mixed(stores, idxs, wts, 2,
                                             PARALLEL_LRS)
        loss = float(ls) / float(n)  # synchronises
        out.append({"loss": loss, "seconds": time.perf_counter() - t0,
                    "steps": int(wts.shape[0]), "buckets": len(stores)})
    return out


def _prob_trees_agree(a: Path, b: Path, what: str,
                      subset: bool = False) -> dict:
    """Two ``.prob.csv`` trees: the same files (with ``subset``, ``a``'s
    files among ``b``'s) and ids, the same argmax outside ties within two
    quanta, values within ``PROB_BOUND``."""
    files_a = sorted(p.relative_to(a) for p in a.rglob("*.prob.csv"))
    files_b = sorted(p.relative_to(b) for p in b.rglob("*.prob.csv"))
    if subset:
        files_b = [f for f in files_b if f in files_a]
    check(files_a == files_b and files_a, f"{what}: CSV files differ")
    worst, rows, argmax_diff = 0.0, 0, 0
    for rel in files_a:
        ra = np.array([[float(v) for v in line.split(",")]
                       for line in (a / rel).read_text().splitlines()[1:]])
        rb = np.array([[float(v) for v in line.split(",")]
                       for line in (b / rel).read_text().splitlines()[1:]])
        check(ra.shape == rb.shape and (ra[:, 0] == rb[:, 0]).all(),
              f"{what}: ROI ids differ in {rel}")
        pa, pb = ra[:, 1:], rb[:, 1:]
        top2 = np.sort(pa, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * PROB_BOUND
        argmax_diff += int((pa.argmax(1) != pb.argmax(1))[clear].sum())
        worst = max(worst, float(np.abs(pa - pb).max()))
        rows += len(ra)
    check(worst <= PROB_BOUND, f"{what}: max |dp| {worst}")
    check(argmax_diff == 0, f"{what}: argmax differs on {argmax_diff} ROIs")
    return {"files": len(files_a), "rois": rows, "max_abs_dp": worst}


def phase_parallel(run: dict, model_dir: Path, counts: dict,
                   smi: str) -> dict:
    """The multi-GPU path on the one card: a NCCL group at world size 1
    and a data mesh over it. The trainer without a group, then the
    data-parallel trainer (full width, the train phase's set, three epochs
    at stage 2, bfloat16; cuDNN deterministic for both), whose steady
    epochs' losses must be within 1e-5 relative; ``prob`` and the fused pass
    without a mesh and through ``Classifier(mesh=data_mesh())``, the CSVs
    and features compared. Returns K1's and K2's launches on the mesh
    runs."""
    import copy

    import torch.distributed as dist

    from sykepic_tpu_torch import parallel
    from sykepic_tpu_torch.compute import probability
    from sykepic_tpu_torch.compute.engine import Classifier
    from sykepic_tpu_torch.models import registry
    from sykepic_tpu_torch.ops import flood, resize_pad
    from sykepic_tpu_torch.train.config import PreprocessSpec
    from sykepic_tpu_torch.train.device_data import DeviceDataset
    from sykepic_tpu_torch.train.trainer import Trainer
    from sykepic_tpu_torch.utils import files

    check(not parallel.is_initialized(), "a process group is already up")
    spec = PreprocessSpec(180, 180, 3, border="mode")
    aug = dict(flip=True, translate=True, zoom=True, brightness=True,
               zoom_range=(0.6, 1.4), brightness_range=(0.95, 1.1))
    paths = sorted(run["dataset"].rglob("*.png"))
    labels = [int(p.parent.name.split("_")[1]) for p in paths]
    t0 = time.perf_counter()
    ds = DeviceDataset(paths, labels, spec, 256, seed=3, shuffle=True,
                       device="cuda")
    set_up_s = time.perf_counter() - t0
    plans = [ds.epoch_mixed_stacked(shuffle=True) for _ in range(3)]
    model0 = registry.init_weights(registry.build_model(
        "resnet18", TRAIN_CLASSES, head=(256, 128)), seed=1)
    samples = list(counts)
    small = files.list_sample_paths(WORK / "raw_compare")

    def trainer(mesh=None):
        return Trainer(copy.deepcopy(model0), "Adam", spec, aug, seed=5,
                       device="cuda", dtype="bfloat16", mesh=mesh)

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        # without a group: the trainer twice (the run-to-run floor), then
        # prob and the fused pass
        plain = _epochs(trainer(), plans)
        again = _epochs(trainer(), plans)
        out_plain, out_mesh = WORK / "par_plain", WORK / "par_mesh"
        t0 = time.perf_counter()
        probability.main(samples, model_dir, out_plain, BATCH, force=True,
                         progress_bar=False)
        torch.cuda.synchronize()
        prob_plain_s = time.perf_counter() - t0
        fused_plain = fused(Classifier(model_dir, batch_size=BATCH), small)

        dev = parallel.init_process_group("cuda", WORK / "nccl_store", 0, 1)
        try:
            mesh = parallel.data_mesh()
            check(dist.get_backend() == "nccl", "the group is not NCCL")
            resize_pad.launches = resize_pad.train_launches = 0
            dp = trainer(mesh)
            check(dp.mesh is mesh and dp.n_data == 1, "no data mesh")
            par = _epochs(dp, plans)
            torch.cuda.synchronize()
            k1_train = resize_pad.train_launches
            want = sum(e["buckets"] * e["steps"] for e in par)
            check(k1_train == want, f"K1's train form launched {k1_train} "
                  f"times on the mesh for {want} bucket-steps")

            resize_pad.launches = 0
            t0 = time.perf_counter()
            probability.main(samples, model_dir, out_mesh, BATCH,
                             force=True, progress_bar=False, mesh=mesh)
            torch.cuda.synchronize()
            prob_s = time.perf_counter() - t0
            k1_prob = resize_pad.launches
            dispatches = count_dispatches(samples)
            check(k1_prob == dispatches, f"K1 launched {k1_prob} times on "
                  f"the mesh for {dispatches} dispatches")

            for c in FLOOD_COUNTERS.values():
                setattr(flood, c, 0)
            resize_pad.launches = 0
            clf = Classifier(model_dir, batch_size=BATCH, mesh=mesh)
            fused_mesh = fused(clf, small)
            clf.release()
            torch.cuda.synchronize()
            k1_fused, k2_fused = resize_pad.launches, flood_counts()
            check(k1_fused > 0 and sum(k2_fused.values()) > 0,
                  "the fused pass on the mesh launched no K1 or K2")
        finally:
            parallel.destroy_process_group()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det

    rel = [abs(b["loss"] - a["loss"]) / abs(a["loss"])
           for a, b in zip(plain, par)]
    floor = [abs(b["loss"] - a["loss"]) / abs(a["loss"])
             for a, b in zip(plain, again)]
    check(all(np.isfinite([e["loss"] for e in par])), "non-finite loss")
    check(max(rel[1:]) <= PARALLEL_LOSS_RTOL,
          f"the data-parallel steady epochs' losses are {rel[1:]} off")
    prob = _prob_trees_agree(out_plain, out_mesh, "prob under the mesh")
    check(fused_plain.keys() == fused_mesh.keys(), "fused ROI sets differ")
    keys = sorted(fused_plain)
    dp_fused = max(float(np.abs(fused_plain[k][0] - fused_mesh[k][0]).max())
                   for k in keys)
    feat_rel = max(float(np.max(np.abs(fused_plain[k][1] - fused_mesh[k][1])
                                / np.maximum(np.abs(fused_plain[k][1]), 1)))
                   for k in keys)
    check(dp_fused <= PROB_BOUND and feat_rel <= 1e-5,
          f"fused pass under the mesh: |dp| {dp_fused}, features {feat_rel}")

    def step_ms(epochs):  # the steady epochs 2 and 3
        return 1e3 * sum(e["seconds"] for e in epochs[1:]) / sum(
            e["steps"] for e in epochs[1:])

    out = {"phase": "parallel", "gpu": smi, "backend": "nccl",
           "nccl_available": dist.is_nccl_available(), "world_size": 1,
           "device": str(dev), "set_up_s": set_up_s,
           "train": {"images": len(paths), "batch": 256, "dtype": "bfloat16",
                     "cudnn_deterministic": True,
                     "epochs_plain": plain, "epochs_plain_again": again,
                     "epochs_group": par, "loss_rel_diff": rel,
                     "loss_rel_diff_plain_again": floor,
                     "steady_step_ms_plain": step_ms(plain),
                     "steady_step_ms_plain_again": step_ms(again),
                     "steady_step_ms_group": step_ms(par),
                     "k1_train_launches": k1_train},
           "prob": {**prob, "seconds_plain": prob_plain_s,
                    "rois_per_s_plain": sum(counts.values()) / prob_plain_s,
                    "seconds_mesh": prob_s,
                    "rois_per_s_mesh": sum(counts.values()) / prob_s,
                    "dispatches": dispatches, "k1_launches": k1_prob},
           "pipeline": {"rois": len(keys), "max_abs_dp": dp_fused,
                        "feat_max_rel_diff": feat_rel,
                        "k1_launches": k1_fused, "k2_launches": k2_fused}}
    emit(out)
    return {"k1": {"train": k1_train, "prob": k1_prob, "pipeline": k1_fused},
            "k2": sum(k2_fused.values())}


# -- the deployment path: host features, pipeline, watch, export --------------

HOST_ROIS = 1000  # the host-thread pipeline's synthetic ROIs
HOST_PER_SAMPLE = 100
HOST_THREADS = 8  # pipeline -w, the CLI's default
SCALING_ROIS = 200  # ROIs of the host features' thread-scaling case
SCALING_THREADS = (1, 2, 4, 8)


def feat_trees_identical(a: Path, b: Path, what: str,
                         subset: bool = False) -> int:
    """Two ``.feat.csv`` trees byte for byte (with ``subset``, ``a``'s
    files among ``b``'s), every file under ``# version=tpu-v1``; returns
    the number of files."""
    files_a = sorted(p.relative_to(a) for p in a.rglob("*.feat.csv"))
    files_b = sorted(p.relative_to(b) for p in b.rglob("*.feat.csv"))
    if subset:
        files_b = [f for f in files_b if f in files_a]
    check(files_a == files_b and files_a, f"{what}: feat CSV files differ")
    for rel in files_a:
        body = (a / rel).read_bytes()
        check(body.startswith(b"# version=tpu-v1\n"), f"{what}: {rel} version")
        check(body == (b / rel).read_bytes(), f"{what}: {rel} differs")
    return len(files_a)


def feature_rate(images, threads: int) -> float:
    """ROIs/s of ``compute_features`` over ``images`` on ``threads`` host
    threads, from an empty filter-bank cache."""
    from concurrent.futures import ThreadPoolExecutor

    from sykepic_tpu_torch.compute import features

    with features._bank_lock:
        features._bank_cache.clear()
        features._bank_cache_total = 0
    t0 = time.perf_counter()
    if threads == 1:
        for img in images:
            features.compute_features(img)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(features.compute_features, images))
    return len(images) / (time.perf_counter() - t0)


def phase_pipeline_host(model_dir: Path) -> dict:
    """The host-thread ``pipeline`` (features on ``HOST_THREADS`` host
    threads beside the classification on the card) through the CLI, cold
    and warm under torch.profiler; held against ``prob`` and ``feat`` on the
    same samples; the host features alone at ``SCALING_THREADS`` threads.
    Returns K1's launches of the cold run and what the ``watch`` phase
    reads."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.ingest import ifcb
    from sykepic_tpu_torch.models import checkpoint
    from sykepic_tpu_torch.ops import resize_pad

    raw = WORK / "raw_host"
    counts = build_raw(raw, HOST_ROIS, seed=17, start=datetime(2020, 6, 1),
                       per_sample=HOST_PER_SAMPLE)
    samples = list(counts)
    n_rois = sum(counts.values())
    dispatches = count_dispatches(samples)
    classes = checkpoint.read_class_names(model_dir)
    out = WORK / "out_host"
    argv = ["pipeline", "-r", str(raw), "-m", str(model_dir), "-o", str(out),
            "-b", str(BATCH), "-w", str(HOST_THREADS)]
    runs = {}

    def run(name, force):
        resize_pad.launches = 0
        t0 = time.perf_counter()
        written = main(argv + (["-f"] if force else []))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if name == "cold":
            check(written == {p.name for p in samples},
                  f"pipeline_host: returned {len(written)} of "
                  f"{len(samples)} samples")
        check(resize_pad.launches == dispatches,
              f"pipeline_host {name}: K1 launched {resize_pad.launches} "
              f"times for {dispatches} dispatches")
        runs[name] = {"seconds": seconds, "rois_per_s": n_rois / seconds,
                      "k1_launches": resize_pad.launches}

    run("cold", False)
    check_csvs(out, counts, classes)
    # warm, under torch.profiler: the device's busy share of the wall
    profile = device_profile(lambda: run("warm_profiled", True))

    # the same samples through prob and feat
    prob_out, feat_out = WORK / "out_host_prob", WORK / "out_host_feat"
    main(["prob", "-r", str(raw), "-m", str(model_dir), "-o", str(prob_out),
          "-b", str(BATCH)])
    prob_cmp = _prob_trees_agree(out, prob_out, "pipeline_host vs prob")
    t0 = time.perf_counter()
    main(["feat", "-r", str(raw), "-o", str(feat_out), "-p"])
    feat_s = time.perf_counter() - t0
    n_feat = feat_trees_identical(out, feat_out, "pipeline_host vs feat")

    images = [img for p in samples[1:] for _, img in
              ifcb.read_sample(p).images()][:SCALING_ROIS]
    rates = {f"threads_{n}": feature_rate(images, n)
             for n in SCALING_THREADS}
    emit({"phase": "pipeline_host", "rois": n_rois, "samples": len(samples),
          "batch": BATCH, "feature_threads": HOST_THREADS,
          "dispatches": dispatches, "runs": runs,
          "device_busy_share": profile["device_busy_share"],
          "device_busy_ms": profile["device_busy_ms"],
          "k1_share_of_device": profile["k1_share_of_device"],
          "device_ms_by_kind": profile["device_ms_by_kind"],
          "cpu_count": os.cpu_count(),
          "host_features_rois_per_s": {"rois": len(images), **rates},
          "vs_prob": prob_cmp, "feat_csvs_identical": n_feat,
          "feat_parallel_seconds": feat_s})
    return {"launches": runs["cold"]["k1_launches"], "out": out,
            "samples": samples}


def settled_copy(sample: Path, raw_dir: Path) -> None:
    """Copy a raw triplet into ``raw_dir`` with an hour-old mtime."""
    past = time.time() - 3600
    for suffix in (".adc", ".roi", ".hdr"):
        dst = raw_dir / (sample.name + suffix)
        shutil.copy(sample.with_suffix(suffix), dst)
        os.utime(dst, (past, past))


def phase_watch(model_dir: Path, host: dict) -> int:
    """The ``watch`` daemon on the card over three of ``pipeline_host``'s
    samples: the fixture and one synthetic sample settled at the start, a
    third copied in by the sleep hook after cycle 1. Each is processed
    exactly once, all three are returned, and the CSVs equal
    ``pipeline_host``'s. Returns K1's launches."""
    from sykepic_tpu_torch.compute import pipeline, probability, watch
    from sykepic_tpu_torch.ops import resize_pad

    raw = WORK / "raw_watch"
    raw.mkdir()
    first, second, third = host["samples"][:3]
    settled_copy(first, raw)
    settled_copy(second, raw)
    out = WORK / "out_watch"
    clf = probability.prepare_model(model_dir, batch_size=BATCH)
    calls = []
    real_main = pipeline.main

    def recording(paths, *args, **kwargs):
        calls.append(sorted(p.name for p in paths))
        return real_main(paths, *args, **kwargs)

    sleeps = []

    def hook(seconds):
        sleeps.append(seconds)
        if len(sleeps) == 1:  # after cycle 1: a new sample arrives
            settled_copy(third, raw)

    pipeline.main = recording
    try:
        resize_pad.launches = 0
        t0 = time.perf_counter()
        done = watch.run(raw, clf, out, interval=0, settle_seconds=0,
                         max_cycles=2, sleep=hook)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        pipeline.main = real_main
    launches = resize_pad.launches
    names = {first.name, second.name, third.name}
    check(done == names, f"watch returned {sorted(done)}")
    check(calls == [sorted([first.name, second.name]), [third.name]],
          f"watch processed {calls}: not each sample exactly once")
    check(launches > 0, "watch never launched K1")
    prob_cmp = _prob_trees_agree(out, host["out"], "watch vs pipeline_host",
                                 subset=True)
    n_feat = feat_trees_identical(out, host["out"], "watch vs pipeline_host",
                                  subset=True)
    emit({"phase": "watch", "cycles": 2, "calls": calls,
          "seconds": seconds, "k1_launches": launches,
          "vs_pipeline_host": prob_cmp, "feat_csvs_identical": n_feat})
    return launches


def phase_export(run: dict) -> dict:
    """``python -m sykepic_tpu_torch export`` on the ``train`` phase's
    model directory (``best_state.msgpack`` written by the port); a second
    directory holding only ``config.ini``, ``class_names.txt`` and that
    ``best_state.pth`` classifies the comparison set on the card exactly
    as the msgpack directory does."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.models import checkpoint

    model_dir = Path(run["model_dir"])
    check((model_dir / checkpoint.BEST_STATE).is_file(),
          "the train phase wrote no best_state.msgpack")
    with contextlib.redirect_stdout(sys.stderr):  # its "Wrote ..." line
        main(["export", str(model_dir)])
    pth = model_dir / checkpoint.TORCH_STATE
    state = torch.load(pth, map_location="cpu", weights_only=True)
    check(any(k.startswith("base.") for k in state),
          "export wrote no reference base.N keys")
    pth_dir = WORK / "export_pth_only"
    pth_dir.mkdir()
    for f in ("config.ini", "class_names.txt", checkpoint.TORCH_STATE):
        shutil.copy(model_dir / f, pth_dir)
    raw = WORK / "raw_compare"
    outs = {}
    for tag, d in (("msgpack", model_dir), ("pth", pth_dir)):
        outs[tag] = WORK / f"out_export_{tag}"
        main(["prob", "-r", str(raw), "-m", str(d), "-o", str(outs[tag]),
              "-b", str(BATCH)])
    cmp = _prob_trees_agree(outs["pth"], outs["msgpack"], "export")
    check(cmp["max_abs_dp"] == 0.0,
          f"export: the .pth dir differs by {cmp['max_abs_dp']}")
    out = {"phase": "export", "keys": len(state), "pth_bytes":
           pth.stat().st_size, **cmp}
    emit(out)
    return out


CSV_THRESHOLDS = REPO / "tests/model/thresholds-2021.txt"
CSV_ZERO = REPO / "tests/model/thresholds-zero.txt"
CSV_GROUPS = REPO / "tests/model/size-groups.txt"
SELECTED_SAMPLES = 3  # samples of the evaluate phase's selection tree


def _csv_rows(path: Path) -> list:
    """The data lines of a CSV, past its ``#`` comments and header."""
    lines = [line for line in path.read_text().splitlines()
             if line and not line.startswith("#")]
    return lines[1:]


def _csv_table(path: Path):
    """``(header, rows)`` of a written CSV, ``rows`` as lists of strings."""
    lines = path.read_text().splitlines()
    return lines[0].split(","), [line.split(",") for line in lines[1:]]


def phase_csv_tools(host: dict) -> dict:
    """The pandas CSV sub-commands through ``python -m sykepic_tpu_torch``,
    one process each, on the ``.prob.csv`` and ``.feat.csv`` trees that
    ``pipeline_host`` wrote: ``class``, ``size``, ``abundance``,
    ``class_stats``, ``features_per_prediction``, ``evaluate --search``
    (on a selection tree labelled from the prob CSVs) and ``frequency``.
    Checked: every output exists; ``class``, ``size`` and ``abundance`` give
    one row a sample and ``frequency`` one a timestamp; at zero thresholds
    ``abundance``'s per-class counts equal the argmax counts computed here
    with numpy, and ``frequency``'s cells sum to the ROIs; the sum of
    ``size``'s per-group counts equals the ROIs its exclusion list lets
    through."""
    root = WORK / "csv_tools"
    probs, feats, evals, out = (root / d for d in
                                ("probs", "feats", "evals", "out"))
    for d in (probs, feats, evals, out):
        d.mkdir(parents=True)
    for src in sorted(host["out"].rglob("*.csv")):
        dst = (probs if src.name.endswith(".prob.csv") else feats) / \
            src.relative_to(host["out"])
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    prob_csvs = sorted(probs.rglob("*.prob.csv"))
    feat_csvs = sorted(feats.rglob("*.feat.csv"))
    samples = [p.name.removesuffix(".prob.csv") for p in prob_csvs]
    check(len(prob_csvs) == len(feat_csvs) == len(host["samples"]),
          f"csv_tools: {len(prob_csvs)} prob and {len(feat_csvs)} feat CSVs "
          f"for {len(host['samples'])} samples")
    classes = prob_csvs[0].read_text().splitlines()[0].split(",")[1:]

    # argmax counts with numpy over the ROIs present in both trees (the
    # post-processing joins the two on the ROI id)
    argmax = {}
    feat_rois = {}
    for p_csv, f_csv, name in zip(prob_csvs, feat_csvs, samples):
        rows = np.array([[float(v) for v in line.split(",")]
                         for line in _csv_rows(p_csv)]).reshape(
            -1, len(classes) + 1)
        ids = {int(line.split(",")[0]) for line in _csv_rows(f_csv)}
        feat_rois[name] = len(ids)
        both = np.isin(rows[:, 0].astype(int), sorted(ids))
        argmax[name] = np.bincount(rows[both, 1:].argmax(1),
                                   minlength=len(classes))
    n_rois = sum(len(_csv_rows(p)) for p in prob_csvs)

    # a selection tree: every ROI of the first synthetic samples labelled
    # with its argmax class, every fifth one "unclassifiable"
    for p_csv in prob_csvs[1:1 + SELECTED_SAMPLES]:
        lines = []
        for k, line in enumerate(_csv_rows(p_csv)):
            vals = line.split(",")
            best = classes[int(np.argmax([float(v) for v in vals[1:]]))]
            lines.append(f"{vals[0]},"
                         f"{'unclassifiable' if k % 5 == 0 else best}")
        (evals / p_csv.name.replace(".prob.csv", ".select.csv")).write_text(
            "\n".join(lines) + "\n")
    exclusion = root / "exclude.txt"
    exclusion.write_text(samples[-1] + "\n")

    commands = {
        "class": ["class", probs, "--feat", feats, "-t", CSV_THRESHOLDS,
                  "-o", out / "class.csv"],
        "size": ["size", feats, "-g", CSV_GROUPS, "-s", "biovolume_um3",
                 "-v", "abundance", "--volume", "-q", "-exc", exclusion,
                 "-o", out / "size.csv"],
        "abundance": ["abundance", probs, "--feat", feats, "-t", CSV_ZERO,
                      "-o", out / "abundance.csv"],
        "class_stats": ["class_stats", probs, "--feat", feats,
                        "-t", CSV_ZERO, "-o", out / "class_stats.csv"],
        "features_per_prediction": ["features_per_prediction", probs,
                                    "--feat", feats, "-t", CSV_ZERO,
                                    "-o", out / "fpp.csv"],
        "evaluate": ["evaluate", evals, probs, "--search", "-p", "0.1",
                     "-o", out / "scores.csv", "--best-out",
                     out / "best.txt"],
        "frequency": ["frequency", probs, "-t", CSV_ZERO,
                      "-o", out / "frequency.csv"],
    }
    seconds = {}
    for name, argv in commands.items():
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "sykepic_tpu_torch",
                        *map(str, argv)], cwd=REPO, check=True,
                       capture_output=True)
        seconds[name] = time.perf_counter() - t0
    expected = ("class.csv", "size.csv", "abundance.csv", "class_stats.csv",
                "fpp1.csv", "scores.csv", "best.txt", "frequency.csv")
    for f in expected:
        check((out / f).is_file() and (out / f).stat().st_size,
              f"csv_tools: {f} missing or empty")

    header, rows = _csv_table(out / "class.csv")
    check(header[0] == "Time" and header[-1] == "Total"
          and "Filamentous cyanobacteria" in header,
          f"class: header {header[:3]}...{header[-3:]}")
    check(len(rows) == len(samples), f"class: {len(rows)} rows for "
          f"{len(samples)} samples")

    header, rows = _csv_table(out / "size.csv")
    groups = sorted((line.split() for line in
                     CSV_GROUPS.read_text().splitlines() if line.strip()),
                    key=lambda g: float(g[1]))
    check(header == ["time"] + [g[0] for g in groups] + ["total",
                                                         "volume_ml"],
          f"size: header {header}")
    check(len(rows) == len(samples) - 1, f"size: {len(rows)} rows for "
          f"{len(samples) - 1} samples past the exclusion list")
    size_sum = sum(float(v) for r in rows for v in r[1:1 + len(groups)])
    size_want = sum(n for s, n in feat_rois.items() if s != samples[-1])
    check(size_sum == size_want, f"size: per-group counts sum to "
          f"{size_sum}, want {size_want}")

    header, rows = _csv_table(out / "abundance.csv")
    check(len(rows) == len(samples), f"abundance: {len(rows)} rows")
    want_names = [c.replace("_", " ") for c in classes]
    col = {name: k for k, name in enumerate(header)}
    for (name, counts), row in zip(argmax.items(), rows):
        got = [int(row[col[c]]) for c in want_names]
        check(got == counts.tolist(),
              f"abundance: {name} counts differ from the argmax counts")

    header, rows = _csv_table(out / "class_stats.csv")
    check(header[:2] == ["class", "sample"] and len(header) == 18 and rows,
          f"class_stats: header {header}")
    fpp = sorted(out.glob("fpp*.csv"))
    months = {s[5:7] for s in samples}
    check(len(fpp) == len(months), f"features_per_prediction wrote "
          f"{len(fpp)} chunks for months {sorted(months)}")

    header, rows = _csv_table(out / "scores.csv")
    check({"tp", "fp", "fn", "precision", "recall", "F1"} <= set(header)
          and rows, f"evaluate: header {header}")
    best = [line.split() for line in
            (out / "best.txt").read_text().splitlines()]
    check(best and all(0.0 <= float(v) <= 1.0 for _, v in best),
          f"evaluate: best thresholds {best[:3]}")

    header, rows = _csv_table(out / "frequency.csv")
    check(len(rows) == len(samples), f"frequency: {len(rows)} rows for "
          f"{len(samples)} samples")
    freq_sum = sum(float(v) for r in rows for v in r[1:] if v)
    check(freq_sum == n_rois, f"frequency: cells sum to {freq_sum}, "
          f"want {n_rois}")
    out_line = {"phase": "csv_tools", "samples": len(samples),
                "rois": n_rois, "seconds": seconds,
                "abundance_classes_checked": len(classes),
                "size_rois": size_want, "selected_samples": SELECTED_SAMPLES,
                "best_thresholds": len(best), "fpp_chunks": len(fpp)}
    emit(out_line)
    return out_line


def phase_train_side(run: dict) -> dict:
    """``train``'s side modes on the ``train`` phase's dataset, through the
    CLI's ``main``: ``--collage 8 8`` on the card with K1's launch counter
    set to 0 just before and read just after (it must rise); each of its
    K1 calls held against the plain version on the same inputs; the same
    collage with augmentations off on the card and on ``--device cpu``,
    equal pixel for pixel; ``--save-images`` with ``--dist``, which draws
    the distribution where matplotlib imports and must raise where it does
    not. Returns the collage's K1 launches."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.analyze import plot
    from sykepic_tpu_torch.ops import resize_pad
    from sykepic_tpu_torch.ops.preprocess import resize_pad_plain
    from sykepic_tpu_torch.utils import png

    root = WORK / "train_side"
    root.mkdir()
    dataset = Path(run["dataset"])
    inis = {}
    for name, augs in (("augmented", "flip, translate, zoom, rotate, "
                        "brightness"), ("plain", "")):
        text = TRAIN_INI.format(dataset=dataset, models=root / "models",
                                epochs=1).replace(
            "augmentations = flip, translate, zoom, brightness",
            f"augmentations = {augs}")
        inis[name] = root / f"{name}.ini"
        inis[name].write_text(text)

    calls = []
    real_k1 = resize_pad.resize_pad

    def recording(pixels, meta, *args, **kwargs):
        out = real_k1(pixels, meta, *args, **kwargs)
        if pixels.is_cuda:
            calls.append((pixels.cpu(), meta.cpu(), args, kwargs,
                          out.cpu()))
        return out

    seconds = {}
    resize_pad.resize_pad = recording
    try:
        resize_pad.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # its [INFO] line
            card_png = main(["train", str(inis["augmented"]), "--collage",
                             "8", "8", str(root / "collage")])
        torch.cuda.synchronize()
        seconds["collage_card"] = time.perf_counter() - t0
        launches = resize_pad.launches
    finally:
        resize_pad.resize_pad = real_k1
    check(launches > 0, "train --collage never launched K1")
    check(len(calls) == launches, f"collage: {len(calls)} recorded K1 "
          f"calls for {launches} launches")
    worst = 0.0
    for pixels, meta, args, kwargs, got in calls:
        want = resize_pad_plain(pixels, meta, *args, **kwargs)
        worst = max(worst, float((got - want).abs().max()))
    check(worst <= 1e-3, f"collage: K1 differs from its plain version by "
          f"{worst} (0-255 scale)")
    img = png.read_png(card_png)
    check(img.shape == (8 * 180, 8 * 180), f"collage shape {img.shape}")

    plain = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            path = main(["train", str(inis["plain"]), "--device", device,
                         "--collage", "8", "8",
                         str(root / f"plain_{device}.png")])
        seconds[f"collage_plain_{device}"] = time.perf_counter() - t0
        plain[device] = png.read_png(path)
    diff = int(np.abs(plain["cuda"].astype(int) - plain["cpu"]).max())
    check(diff == 0, f"collage: the card's plain collage differs from the "
          f"CPU's by {diff} levels")
    check(not np.array_equal(img, plain["cuda"]),
          "collage: the augmentations changed nothing")

    has_mpl = plot.available()
    images, dist = root / "images", root / "dist.png"
    t0 = time.perf_counter()
    argv = ["train", str(inis["plain"]), "--save-images", str(images),
            "--dist", str(dist)]
    with contextlib.redirect_stdout(sys.stderr):
        if has_mpl:
            main(argv)
        else:
            try:
                main(argv)
            except ImportError:
                pass
            else:
                raise AssertionError("train --dist succeeded without "
                                     "matplotlib")
    seconds["save_images_dist"] = time.perf_counter() - t0
    copied = {d: len(list((images / d).iterdir()))
              for d in ("train", "val", "test")}
    check(sum(copied.values()) == TRAIN_IMAGES,
          f"save-images copied {copied} of {TRAIN_IMAGES}")
    check(dist.is_file() == has_mpl, f"dist: file {dist.is_file()}, "
          f"matplotlib {has_mpl}")
    check(not (root / "models").exists(), "a side mode trained a model")
    out = {"phase": "train_side", "collage": [8, 8], "k1_launches": launches,
           "k1_calls_checked": len(calls), "k1_max_abs_err": worst,
           "card_vs_cpu_max_level_diff": diff, "saved_images": copied,
           "matplotlib_importable": has_mpl, "dist_written": dist.is_file(),
           "seconds": seconds}
    emit(out)
    return out


EMPTY_SAMPLE = "D20200101T120000_IFCB114"


def phase_edge_zero_roi(model_dir: Path) -> dict:
    """A sample whose adc rows are all empty triggers (w = h = 0) through
    ``prob`` and ``pipeline --device-features`` on the card: each writes
    its header-only CSVs (the ``.prob.csv`` header; the ``.feat.csv``'s two
    comment lines and column header) and launches neither kernel. Returns
    the launches, counted from 0 around each run."""
    from sykepic_tpu_torch.__main__ import main as cli
    from sykepic_tpu_torch.models import checkpoint
    from sykepic_tpu_torch.ops import flood, resize_pad
    from sykepic_tpu_torch.utils import files

    raw = WORK / "raw_empty"
    raw.mkdir(parents=True)
    (raw / f"{EMPTY_SAMPLE}.adc").write_text(
        "\n".join(",".join(["0"] * 24) for _ in range(3)) + "\n")
    (raw / f"{EMPTY_SAMPLE}.roi").write_bytes(b"")
    (raw / f"{EMPTY_SAMPLE}.hdr").write_text("runTime: 60\ninhibitTime: 1\n")
    header = "roi," + ",".join(checkpoint.read_class_names(model_dir))
    launches = {}
    for name, extra in (("prob", []),
                        ("pipeline", ["--device-features"])):
        out = WORK / f"out_empty_{name}"
        resize_pad.launches = resize_pad.train_launches = 0
        flood.warp_launches = flood.launches = flood.global_launches = 0
        cli([name, "-r", str(raw), "-m", str(model_dir), "-o", str(out),
             "-b", str(BATCH)] + extra)
        torch.cuda.synchronize()
        launches[name] = {"k1": resize_pad.launches + resize_pad.train_launches,
                          "k2": sum(flood_counts().values())}
        check(launches[name] == {"k1": 0, "k2": 0},
              f"edge_zero_roi {name}: kernels launched {launches[name]}")
        prob = files.sample_csv_path(raw / EMPTY_SAMPLE, out, ".prob")
        check(prob.read_text().splitlines() == [header],
              f"edge_zero_roi {name}: {prob.name} is not header-only")
        if extra:
            feat = files.sample_csv_path(raw / EMPTY_SAMPLE, out, ".feat")
            lines = feat.read_text().splitlines()
            check(len(lines) == 3 and lines[2].startswith("roi,"),
                  f"edge_zero_roi {name}: {feat.name} has {len(lines)} lines")
    emit({"phase": "edge_zero_roi", "launches": launches})
    return launches


@contextlib.contextmanager
def native_off():
    """The port's NumPy twins: ``native.lib()`` returns None inside."""
    from sykepic_tpu_torch.ingest import native

    lib = native.lib
    native.lib = lambda: None
    try:
        yield
    finally:
        native.lib = lib


def fuzz_adc(rng) -> bytes:
    """One random well-formed .adc body: 18-29 columns, integer or
    ``.000`` start bytes, LF or CRLF, with or without a final newline."""
    lines = []
    for _ in range(int(rng.integers(1, 30))):
        cols = [str(rng.integers(0, 10**6))
                for _ in range(int(rng.integers(18, 30)))]
        cols[15] = str(int(rng.integers(0, 2000)))
        cols[16] = str(int(rng.integers(0, 2000)))
        start = int(rng.integers(0, 10**9))
        cols[17] = f"{start}.000" if rng.random() < 0.3 else str(start)
        lines.append(",".join(cols))
    sep = "\r\n" if rng.random() < 0.3 else "\n"
    raw = sep.join(lines)
    return (raw + sep if rng.random() < 0.5 else raw).encode()


HOST_ADC_CASES = 50
HOST_SHELF_ROIS = 3000
HOST_PNG_CASES = 24


def phase_host_native() -> dict:
    """The port's native host library, as this machine's compiler built
    it, against its NumPy twins (``native.lib()`` patched to None) on
    seeded cases, exact: the ADC parser on fuzzed bodies; the shelf
    packer's placement, blit and modes on a stream in ``bench.py``'s size
    mix; the wire codec's encoder on those windows and on flat, ramp and
    saturated ones; the PNG row unfilter at 1, 3 and 4 bytes a pixel with
    all five filters. Prints each side's seconds (host time)."""
    from sykepic_tpu_torch.ingest import ifcb, native, pack, shelf, wirecodec
    from sykepic_tpu_torch.utils import png

    check(native.lib() is not None, "the native host library did not build")
    rng = np.random.default_rng(11)
    seconds = {"native": {}, "twin": {}}

    def both(name, fn):
        """``fn()`` on the library, then on the twins; seconds summed by
        ``name``."""
        results = []
        for side in ("native", "twin"):
            with native_off() if side == "twin" else contextlib.nullcontext():
                t0 = time.perf_counter()
                results.append(fn())
                seconds[side][name] = (seconds[side].get(name, 0.0)
                                       + time.perf_counter() - t0)
        return results

    WORK.mkdir(parents=True, exist_ok=True)
    adc = WORK / "fuzz.adc"
    for case in range(HOST_ADC_CASES):
        adc.write_bytes(fuzz_adc(rng))
        got, want = both("adc_parse", lambda: ifcb.parse_adc(adc))
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"host_native: adc_parse case {case} differs from its twin")

    images = fixture_images()
    blocks, placed = [], 0
    for s in range(0, HOST_SHELF_ROIS, PER_SAMPLE):
        imgs = [resampled(rng, images, h, w)
                for h, w in roi_shapes(rng, min(PER_SAMPLE,
                                                HOST_SHELF_ROIS - s))]
        hs = np.array([im.shape[0] for im in imgs], np.int64)
        ws = np.array([im.shape[1] for im in imgs], np.int64)
        offs = np.concatenate([[0], np.cumsum(hs * ws)[:-1]]).astype(np.int64)
        blocks.append(pack.RoiBlock(
            sample_idx=len(blocks), roi_ids=np.arange(1, len(imgs) + 1),
            heights=hs, widths=ws, offsets=offs,
            base=np.concatenate([im.ravel() for im in imgs])))
        placed += len(imgs)

    def packed():
        return [(b.windows.copy(), b) for b in shelf.pack_shelves(
            iter(blocks), pre_shrink_to=(180, 180), compute_modes=True,
            slot_cap=min(shelf.SLOT_CAP, max(BATCH, 1024)))]

    got, want = both("shelf_pack", packed)
    check(len(got) == len(want), "host_native: shelf dispatch counts differ")
    for (wa, a), (wb, b) in zip(got, want):
        check(a.n_valid == b.n_valid and np.array_equal(wa, wb) and all(
            np.array_equal(getattr(a, f), getattr(b, f))
            for f in ("win_idx", "y0", "x0", "heights", "widths", "roi_ids",
                      "sample_idx", "modes")),
              "host_native: a shelf dispatch differs from its twin's")

    h, w = shelf.WIN_H, shelf.WIN_W
    extremes = np.stack([
        np.full((h, w), 255, np.uint8),
        np.tile((np.arange(w) % 256).astype(np.uint8), (h, 1)),
        np.tile((np.arange(h) % 256).astype(np.uint8)[:, None], (1, w)),
        rng.integers(0, 256, (h, w), np.uint8)])
    windows = [wa for wa, _ in got] + [extremes]
    fields = ("plane", "exc", "flags", "shape", "n_exc", "chunk")
    for i, wins in enumerate(windows):
        enc, ref = both("wire_encode", lambda: wirecodec.encode(wins,
                                                                force=True))
        check(all(np.array_equal(getattr(enc, f), getattr(ref, f))
                  for f in fields),
              f"host_native: wire encode of window set {i} differs")
        check(np.array_equal(wirecodec.decode_reference(enc), wins),
              f"host_native: wire encode of window set {i} is lossy")

    for case in range(HOST_PNG_CASES):
        bpp = (1, 3, 4)[case % 3]
        ih, iw = (int(v) for v in rng.integers(1, 200, 2))
        img = rng.integers(0, 256, (ih, iw * bpp), np.uint8)
        filters = tuple(int(f) for f in rng.integers(0, 5, 7))
        rows = np.ascontiguousarray(png._filter_rows(img, filters, bpp))
        out, twin = both("png_unfilter", lambda: png._unfilter(
            rows.tobytes(), ih, iw * bpp, bpp, "case"))
        check(np.array_equal(out, img) and np.array_equal(twin, img),
              f"host_native: png_unfilter case {case} differs")
    out = {"phase": "host_native", "adc_cases": HOST_ADC_CASES,
           "shelf_rois": placed, "shelf_dispatches": len(got),
           "codec_window_sets": len(windows), "png_cases": HOST_PNG_CASES,
           "seconds": seconds}
    emit(out)
    return out


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
    timed("host_native", phase_host_native)
    model_dir = build_model_dir(WORK)
    raw = WORK / "raw"
    counts = timed("workload", build_raw, raw, N_ROIS, 42,
                   datetime(2018, 7, 12))
    main_case = timed("kernel_resize_pad", phase_kernel, model_dir,
                      list(counts))
    ln = timed("kernel_layernorm", phase_kernel_layernorm, smi)
    dw = timed("kernel_depthwise", phase_kernel_depthwise, smi)
    wa = timed("kernel_window_attention", phase_kernel_window_attention, smi)
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
    edge = timed("edge_zero_roi", phase_edge_zero_roi, model_dir)
    run = timed("train", phase_train, smi)
    k1_train_cases = timed("kernel_resize_pad_train", phase_kernel_train, run)
    k1_train = k1_train_cases["bright_on"]
    k1_bf16 = k1_train_cases["bright_on_bf16"]
    timed("train_step_card_vs_cpu", phase_train_step_compare, run)
    families = timed("families", phase_families, run, smi)
    par = timed("parallel", phase_parallel, run, model_dir, counts, smi)
    host = timed("pipeline_host", phase_pipeline_host, model_dir)
    check(host["launches"] > 0, "the host-thread pipeline never launched K1")
    watch_launches = timed("watch", phase_watch, model_dir, host)
    timed("export", phase_export, run)
    timed("csv_tools", phase_csv_tools, host)
    side = timed("train_side", phase_train_side, run)
    emit({"phase_seconds": seconds})
    k = main_case["f32"]
    emit({"kernels": [{
        "name": "resize_pad",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/resize_pad.cu",
        "replaces": "sykepic_tpu/ops/pallas_preprocess.py:114",
        "launches": launches,
        "pipeline_launches": fused_launches["k1"],
        # each family's prob run, counted from 0 (a positive count each)
        "families_launches": families["prob"],
        # the rotation route of efficientnet_b0's training takes the eval
        # form; convnext_tiny's training the train form
        "families_train_launches": families["train"],
        # prob and the fused pass through Classifier(mesh=) at world size 1
        "parallel_launches": {"prob": par["k1"]["prob"],
                              "pipeline": par["k1"]["pipeline"]},
        # the host-thread pipeline's cold run and the watch daemon's two
        # cycles, each counted from 0
        "pipeline_host_launches": host["launches"],
        "watch_launches": watch_launches,
        # train --collage 8 8 on the card (eval form, raw), counted from 0
        "collage_launches": side["k1_launches"],
        # prob and pipeline --device-features on a zero-ROI sample (0)
        "edge_zero_roi_launches": {k: v["k1"] for k, v in edge.items()},
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "device_ms": k["device_ms"],
        "loop_ms": k["loop_ms"],
        "share_of_bound": k["share_of_bound"],
        "copy_floor_ms": k["copy_floor_ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
        # the same dispatch stored in bfloat16 (prob's bf16 mode);
        # max_abs_err against the plain version cast to bf16
        "bf16": {key: main_case["bf16"][key] for key in K1_LINE_KEYS},
    }, {
        # K1's train form: launches over the train run (one per bucket and
        # step); times on 2,048 slots of its largest store, brightness on
        "name": "resize_pad_train",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/resize_pad.cu",
        "replaces": "sykepic_tpu/ops/pallas_preprocess.py:114",
        "launches": run["launches"]["train"],
        # the data-parallel trainer's three epochs at world size 1
        "parallel_launches": par["k1"]["train"],
        "max_abs_err": k1_train["max_abs_err"],
        # every bucket's launch of the first train step, f32, on its inputs
        "step_buckets_checked": run["step_k1"]["buckets"],
        "step_max_abs_err": run["step_k1"]["max_abs_err_f32"],
        "ms": k1_train["ms"],
        "device_ms": k1_train["device_ms"],
        "loop_ms": k1_train["loop_ms"],
        "share_of_bound": k1_train["share_of_bound"],
        "copy_floor_ms": k1_train["copy_floor_ms"],
        "plain_ms": k1_train["plain_ms"],
        "bound_ms": k1_train["bound_ms"],
        "bound_by": k1_train["bound_by"],
        "library_ms": None,
        # the same 2,048 slots stored in bfloat16, as [train] dtype =
        # bfloat16 stores them; max_abs_err against the plain version cast
        # to bf16 (within one bf16 ulp, checked)
        "bf16": {key: k1_bf16[key] for key in K1_LINE_KEYS},
    }, {
        # ms, plain_ms and bound_ms: the seven floods of the first fused
        # dispatch, summed; launches: every form in the fused run
        "name": "flood",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/flood.cu",
        "replaces": "sykepic_tpu/ops/pallas_flood.py:102",
        "launches": sum(k2_launches.values()),
        "launches_by_form": k2_launches,
        # the fused pass through Classifier(mesh=) at world size 1
        "parallel_launches": par["k2"],
        # pipeline --device-features on a zero-ROI sample (0)
        "edge_zero_roi_launches": edge["pipeline"]["k2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "device_ms": k2["device_ms"],
        "host_us": k2["host_us"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        # times at ConvNeXt-T's stage 1 of a 2,048-slot dispatch with the
        # convolution's bias (the other widths are in kernel_layernorm);
        # launches: ConvNeXt-T's cold prob run (22 a dispatch), each
        # family's beside it
        "name": "layernorm",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/layernorm.cu",
        "replaces": None,
        "launches": families["layernorm"]["convnext_tiny"],
        "families_launches": families["layernorm"],
        "max_abs_err": ln["max_abs_err"],
        "ms": ln["ms"],
        "device_ms": ln["device_ms"],
        "loop_ms": ln["loop_ms"],
        "host_us": ln["host_us"],
        "share_of_bound": ln["share_of_bound"],
        "plain_ms": ln["plain_ms"],
        "bound_ms": ln["bound_ms"],
        "bound_by": "bytes",
        "library_ms": ln["library_ms"],
    }, {
        # times at ConvNeXt-T's stage 1 of a 2,048-slot dispatch (the
        # other shapes are in kernel_depthwise); launches: ConvNeXt-T's
        # cold prob run (18 a dispatch), each family's beside it
        "name": "depthwise",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/depthwise.cu",
        "replaces": None,
        "launches": families["depthwise"]["convnext_tiny"],
        "families_launches": families["depthwise"],
        "max_abs_err": dw["max_abs_err"],
        "ms": dw["ms"],
        "device_ms": dw["device_ms"],
        "loop_ms": dw["loop_ms"],
        "host_us": dw["host_us"],
        "share_of_bound": dw["share_of_bound"],
        "plain_ms": dw["plain_ms"],
        "bound_ms": dw["bound_ms"],
        "bound_by": dw["bound_by"],
        "library_ms": dw["library_ms"],
    }, {
        # times at Swin-T's shifted stage 1 of a 2,048-slot dispatch (the
        # other shapes are in kernel_window_attention); launches: Swin-T's
        # cold prob run (12 a dispatch), each family's beside it, and the
        # eval forward of kernel_window_attention (12); library_ms: SDPA's
        # memory-efficient kernel on the same block's padded windows
        "name": "window_attention",
        "route": "cuda",
        "source": "sykepic_tpu_torch/csrc/window_attention.cu",
        "replaces": None,
        "launches": families["window_attention"]["swin_t"],
        "families_launches": families["window_attention"],
        "forward_launches": wa["forward"]["launches_per_forward"],
        "max_abs_err": wa["max_abs_err"],
        "ms": wa["ms"],
        "device_ms": wa["device_ms"],
        "loop_ms": wa["loop_ms"],
        "host_us": wa["host_us"],
        "share_of_bound": wa["share_of_bound"],
        "plain_ms": wa["plain_ms"],
        "bound_ms": wa["bound_ms"],
        "bound_by": wa["bound_by"],
        "library_ms": wa["library_ms"],
    }], "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
