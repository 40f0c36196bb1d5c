"""The port's CLI over every card of a host, held against one card.

``python -m sykepic_tpu_torch.parallel.multicard [--images N]`` on a host
with more than one visible card runs, each as a user would start it:

1. ``python -m sykepic_tpu_torch train INI``, not under torchrun: the CLI
   starts one process per card by itself. The set is ``N`` seeded PNGs
   (default 1,024) in 8 class folders, ResNet18 at full width (3x180x180,
   batch 256, bf16 autocast), two epochs. It must exit 0, report a data
   mesh over every card, and leave one model directory with every artifact
   and a finite validation loss.
2. ``torchrun --standalone --nproc-per-node C -m sykepic_tpu_torch prob``
   with that model directory, on the repo's raw fixture (``-r``) and on the
   set's PNGs (``--image-dir``), against the same ``prob`` on one card
   (``CUDA_VISIBLE_DEVICES=0``): the same files, ROI ids and argmax, and
   probabilities within 1.2e-5.

It prints one JSON line with the wall seconds of each run and raises on a
failure. Every process it starts has ended when it returns.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .dryrun import FIXTURE, read_prob_csv

CLASSES = 8
PROB_BOUND = 1.2e-5
ARTIFACTS = ("config.ini", "class_names.txt", "class_distribution.csv",
             "best_state.msgpack", "train_state.pt", "test_report.txt")
INI = """
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
num_workers = 4
device_cache = auto

[train]
max_epochs = 2
early_stop_patience = 12
learning_rate = 0.01
optimizer = Adam
dtype = bfloat16

[lr_warmup]
use = no

[lr_reduction]
use = no
"""


def build_set(root: Path, n_images: int, seed: int = 0) -> Path:
    """``n_images`` PNGs in ``CLASSES`` folders ``class_K`` named
    ``cK_III.png`` (so ``prob --image-dir`` groups each class into a sample
    ``cK`` with ROI ids ``III``); sizes 24-160 px, a gray level and stripes
    that follow the class."""
    from ..utils import png

    rng = np.random.default_rng(seed)
    per = n_images // CLASSES
    for k in range(CLASSES):
        d = root / f"class_{k}"
        d.mkdir(parents=True)
        for i in range(1, per + 1):
            h, w = (int(v) for v in rng.integers(24, 161, 2))
            img = rng.normal(40 + 24 * k, 20, (h, w))
            img[::3] += 30 * (k % 2)
            png.write_png(d / f"c{k}_{i:03}.png",
                          np.clip(img, 0, 255).astype(np.uint8), level=1)
    return root


def _run(cmd, log: Path, env=None) -> float:
    """Run ``cmd`` to its end with its output in ``log``; wall seconds.
    Raises with the log's tail when it fails."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                            env=env).returncode
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{' '.join(map(str, cmd))} exited {rc}:\n"
                           + log.read_text()[-4000:])
    return seconds


def compare_prob(one: Path, many: Path) -> dict:
    """Every ``.prob.csv`` under ``one`` against its twin under ``many``."""
    want = sorted(p.relative_to(one) for p in one.rglob("*.prob.csv"))
    got = sorted(p.relative_to(many) for p in many.rglob("*.prob.csv"))
    if not want or want != got:
        raise AssertionError(f"prob files {got} != {want}")
    worst, rois = 0.0, 0
    for rel in want:
        a, b = read_prob_csv(one / rel), read_prob_csv(many / rel)
        if a.keys() != b.keys():
            raise AssertionError(f"{rel}: ROI ids differ")
        for r in a:
            if np.argmax(a[r]) != np.argmax(b[r]):
                raise AssertionError(f"{rel} ROI {r}: argmax differs")
            worst = max(worst, float(np.abs(a[r] - b[r]).max()))
        rois += len(a)
    if not worst <= PROB_BOUND:
        raise AssertionError(f"prob max |diff| {worst} > {PROB_BOUND}")
    return {"files": len(want), "rois": rois, "max_abs_diff": worst}


def run(work: Path, n_images: int = 1024) -> dict:
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        raise RuntimeError(f"needs more than one CUDA card; {cards} visible")
    py = sys.executable
    repo = Path(__file__).resolve().parent.parent.parent
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(repo)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    dataset = build_set(work / "dataset", n_images)
    ini = work / "train.ini"
    ini.write_text(INI.format(dataset=dataset, models=work / "models"))
    out: dict = {"cards": cards, "images": n_images}

    log = work / "train.log"
    out["train_s"] = _run([py, "-m", "sykepic_tpu_torch", "train", str(ini)],
                          log, env)
    text = log.read_text()
    mesh = re.findall(r"\[INFO\] Mesh: (.*)", text)
    if mesh != [f"data={cards}"]:
        raise AssertionError(f"train's mesh {mesh}, not data={cards}")
    (model_dir,) = (work / "models").iterdir()
    missing = [a for a in ARTIFACTS if not (model_dir / a).is_file()]
    if missing:
        raise AssertionError(f"train left no {missing} in {model_dir}")
    state = torch.load(model_dir / "train_state.pt", weights_only=True)
    val_loss = float(state["metrics"]["min_val_loss"])
    if not np.isfinite(val_loss):
        raise AssertionError(f"validation loss {val_loss}")
    out.update(mesh=mesh[0], epochs=int(state["epoch"]), val_loss=val_loss)

    one_env = {**env, "CUDA_VISIBLE_DEVICES": "0"}
    torchrun = [py, "-m", "torch.distributed.run", "--standalone",
                f"--nproc-per-node={cards}"]
    for name, inputs in (("raw", ["-r", str(FIXTURE.parent)]),
                         ("images", ["--image-dir", str(dataset)])):
        args = ["-m", "sykepic_tpu_torch", "prob", *inputs, "-m",
                str(model_dir), "-b", str(16 * cards)]
        one, many = work / f"prob_{name}_1", work / f"prob_{name}_{cards}"
        out[f"prob_{name}_1_s"] = _run(
            [py, *args, "-o", str(one)], work / f"prob_{name}_1.log", one_env)
        out[f"prob_{name}_{cards}_s"] = _run(
            [*torchrun, *args, "-o", str(many)],
            work / f"prob_{name}_{cards}.log", env)
        out[f"prob_{name}"] = compare_prob(one, many)
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="multicard")
    parser.add_argument("--images", type=int, default=1024)
    parser.add_argument("--keep", help="work in this directory and keep it")
    args = parser.parse_args(argv)
    work = Path(args.keep or tempfile.mkdtemp(prefix="sykepic-multicard-"))
    work.mkdir(parents=True, exist_ok=True)
    try:
        print(json.dumps(run(work, args.images)), flush=True)
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
