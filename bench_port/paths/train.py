"""The ``train`` path: steady training as ``train/loop.py`` runs it on a
device-resident set: ``train/device_data.py::DeviceDataset`` plans each
epoch (``epoch_mixed_stacked``) and ``train/trainer.py::Trainer
.train_epoch_mixed`` runs it; the epoch's loss sums are then read back.

Set-up makes the labelled set and the weights from the seed, writes the set
as PNGs into the run's directory, builds the ``DeviceDataset`` over them
(decode, buckets, one store a bucket on the card; the traffic's batch,
shuffled, seeded with the run seed) and the ``Trainer`` (the
configuration's optimizer, augmentations and dtype), then runs one epoch of
the dataset's plan. Its first three steps go one at a time through the
window's own call, and what they leave is kept for the check: each step's
loss, the first gradient as Adam's first moment holds it after one step
(``mu / (1 - b1)``), and the parameters' change after three.

The window runs whole epochs until ``seconds`` have passed, then
synchronizes; the rate counts the images of weight 1.

The check follows the same three steps in the plain reference
(:mod:`bench_port.reference.train`, float32 with TF32 off) from the same
weights, on the images and labels the benchmark made (each planned store
row mapped to its image by the dataset's row maps) and the same generator
seed, and compares per parameter the norm of the first gradient and of the
change after three steps (gap over the larger of the reference leaf's norm
and the median leaf's; the median leaf's gap for the gradient, the largest
for the change); parameters whose reference gradient is under a thousandth
of the median leaf's are left out of the change.

``plan["control"]`` puts a control in the program's place (``CONTROLS``):
``fp8``, the reference in float8, is what the check compares;
``half_batch`` plants a fault in the trainer.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .. import gen
from ..flops import shipped_pixels
from ..reference import train as ref_train

SMALL_GRAD = 1e-3  # of the median leaf's gradient norm: moved by round-off
CHECKED_STEPS = 3
ADAM_B1 = 0.9
CONTROLS = ("fp8", "half_batch")


def augmentations(cfg: dict) -> dict:
    """The reference's augmentation settings from the configuration's
    ``[image]`` section."""
    image = cfg["ini"]["image"]
    names = {a.strip() for a in image["augmentations"].split(",")}

    def pair(key):
        return tuple(float(v) for v in image[key].split(","))

    return {"flip": "flip" in names, "translate": "translate" in names,
            "zoom": "zoom" in names, "brightness": "brightness" in names,
            "zoom_range": pair("zoom_range"),
            "brightness_range": pair("brightness_range")}


def row_images(data) -> dict:
    """``{id(store): array}``: the image index of each row of each of the
    dataset's stores, from its row maps (the dataset made from paths in the
    images' order, each path once)."""
    n = len(data.occ_rows)
    image_of_row = np.empty(data.num_rows, np.int64)
    image_of_row[data.occ_rows] = np.arange(n)
    out = {}
    for bi, key in enumerate(data._bucket_keys):
        rows = np.nonzero(data._bucket_of_row == bi)[0]
        images = np.full(len(data.stores[key]["labels"]), -1, np.int64)
        images[data._local_of_row[rows]] = image_of_row[rows]
        out[id(data.stores[key])] = images
    return out


def leaf_gaps(program: dict, reference: dict, keep=None) -> np.ndarray:
    """``| |p| - |r| | / max(|r|, median |r|)`` of each leaf (by name;
    ``keep``: the names counted)."""
    names = [n for n in reference if keep is None or n in keep]
    ref = np.array([float(reference[n]) for n in names])
    seen = np.array([float(program[n]) for n in names])
    return np.abs(seen - ref) / np.maximum(ref, np.median(ref))


class Run:
    def __init__(self, plan, seed, work: Path, device, net):
        self.cfg, self.traffic = plan["cfg"], plan["traffic"]
        self.limits, self.seed = plan["limits"], seed
        self.work, self.device, self.net = work, device, net
        self.dtype = self.cfg["dtype"]["train"]
        self.target = self.cfg["image_shape"][1]
        self.control = plan.get("control")  # one of CONTROLS, or None

    def setup(self, trace: bool = False) -> None:
        from sykepic_tpu_torch.ops import augment
        from sykepic_tpu_torch.train import config as tcfg
        from sykepic_tpu_torch.train.device_data import DeviceDataset
        from sykepic_tpu_torch.train.trainer import Trainer

        t = self.traffic
        self.images, self.labels = gen.build_train_set(t["set"], self.seed)
        paths = gen.write_train_set(self.work / "set", self.images)
        self.shipped_pixels = shipped_pixels(
            [im.shape for im in self.images], self.target)
        model_dir = gen.write_model_dir(self.work / "model", self.cfg, None)
        config = tcfg.read_config(model_dir / "config.ini")
        spec = tcfg.get_preprocess_spec(config)
        self.data = DeviceDataset(paths, self.labels, spec,
                                  batch_size=t["batch_size"], seed=self.seed,
                                  device=self.device, shuffle=True)
        self.rows = row_images(self.data)
        self.params = gen.make_weights(self.net, self.cfg, self.seed,
                                       self.device, self.images)
        model, _ = tcfg.get_network(config, len(self.cfg["class_names"]))
        model.load_state_dict({k: v.cpu() for k, v in self.params.items()})
        aug = tcfg.get_augment_spec(config)
        self.trainer = Trainer(
            model, optimizer=config.get("train", "optimizer"),
            preprocess_spec=spec,
            augment_kwargs=augment.spec_kwargs(
                aug.augmentations, aug.zoom_range, aug.brightness_range,
                aug.max_rotation),
            seed=self.seed, device=self.device, dtype=self.dtype)
        if self.control == "half_batch":
            half_batch(self.trainer)
        stores, idxs, weights = self.data.epoch_mixed_stacked(shuffle=True)
        self.first = (tuple(id(st) for st in stores), idxs, weights)
        self.seen = {"loss": [], "grad": {}, "change": {}}
        for j in range(CHECKED_STEPS):
            ls, _, n = self._epoch(stores, tuple(i[j:j + 1] for i in idxs),
                                   weights[j:j + 1])
            self.seen["loss"].append(float(ls) / max(float(n), 1.0))
            if j == 0:
                self.seen["grad"] = {
                    name: float(torch.linalg.vector_norm(m.float()))
                    / (1.0 - ADAM_B1)
                    for name, m in zip(self.trainer.names,
                                       self.trainer.opt_state["mu"])}
        self.seen["change"] = {
            name: float(torch.linalg.vector_norm(
                p.detach().float() - self.params[name]))
            for name, p in zip(self.trainer.names, self.trainer.params)}
        self._epoch(stores, tuple(i[CHECKED_STEPS:] for i in idxs),
                    weights[CHECKED_STEPS:])

    def _epoch(self, stores, idxs, weights):
        """One call of the trainer over a plan, its sums read back as
        ``train/loop.py`` reads them."""
        ls, c, n = self.trainer.train_epoch_mixed(
            stores, idxs, weights, self.traffic["stage"],
            self.traffic["lrs"])
        return float(ls), float(c), float(n)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        images = steps = 0
        epoch_s = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t1 = time.perf_counter()
            stores, idxs, weights = self.data.epoch_mixed_stacked(
                shuffle=True)
            self._epoch(stores, idxs, weights)
            images += int(weights.sum())
            steps += len(weights)
            epoch_s.append(time.perf_counter() - t1)
        self._sync()
        elapsed = time.perf_counter() - t0
        self.steps = steps
        return {"e2e": {"train_images_per_s": images / elapsed},
                "tallies": {"images": images, "window_s": elapsed,
                            "epochs": len(epoch_s), "epoch_s": epoch_s,
                            "steps": steps,
                            "shipped_pixels": self.shipped_pixels
                            * len(epoch_s),
                            "dtype": self.dtype, "net": self.net,
                            "stages": {}}}

    def memory_peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def free(self) -> None:
        del self.trainer, self.data
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None) -> dict:
        """The reference's readings of the first three steps."""
        stores, idxs, weights = self.first
        steps = ref_train.Steps(self.params, self.net, self.cfg,
                                augmentations(self.cfg), self.traffic["lrs"],
                                self.seed, self.device, quant=quant)
        out = {"loss": [], "grad": {}}
        for j in range(CHECKED_STEPS):
            parts = []
            for store, idx in zip(stores, idxs):
                members = self.rows[store][idx[j]]
                parts.append(([self.images[i] for i in members],
                              self.labels[members]))
            loss, grads = steps.step(parts, weights[j])
            out["loss"].append(loss)
            if j == 0:
                out["grad"] = {n: float(torch.linalg.vector_norm(g))
                               for n, g in grads.items()}
        out["change"] = {n: float(torch.linalg.vector_norm(
            p - self.params[n].float())) for n, p in steps.params.items()}
        return out

    def compare(self, seen: dict, ref: dict) -> dict:
        """The numbers compared, ``{name: value}``: the median leaf's gap
        of the first gradient's norm, and the largest leaf's gap of the
        change's norm after three steps. The losses are not compared: the
        float8 control and the faults move them by no more than two to
        three times bfloat16's rounding (PERF.md gives the readings)."""
        floor = float(np.median(list(ref["grad"].values())))
        moved = {n for n, g in ref["grad"].items() if g >= SMALL_GRAD * floor}
        return {
            "grad_gap_median_leaf": float(np.median(
                leaf_gaps(seen["grad"], ref["grad"]))),
            "change_gap_worst_leaf": float(
                leaf_gaps(seen["change"], ref["change"], moved).max())}

    @staticmethod
    def aside(seen: dict, ref: dict) -> dict:
        """Numbers left out of the check, for PERF.md: the loss gaps of
        the first step and of the worst of three (Adam's first steps move
        weights of near-nought gradient either way, so the later losses
        swing), and the worst leaf's gradient gap (the stem convolution's,
        behind a BatchNorm of the batch's statistics: a difference of near
        equals)."""
        gaps = [abs(a - b) / abs(b) for a, b in zip(seen["loss"], ref["loss"])]
        return {"loss_gap_step1": gaps[0], "loss_gap_3_steps": max(gaps),
                "grad_gap_worst_leaf": float(leaf_gaps(seen["grad"],
                                                       ref["grad"]).max())}

    def check(self):
        seen = (self.reference(quant="fp8") if self.control == "fp8"
                else self.seen)
        numbers = self.compare(seen, self.reference())
        checks = {k: (v, self.limits[k]["limit"]) for k, v in numbers.items()}
        return checks, self.steps, 0


def half_batch(trainer) -> None:
    """A planted fault: each step trains on the first half of every part's
    rows, the loss their mean."""
    step = trainer._step

    def halved(parts, wts, stage, lrs):
        kept, pos, keep_w = [], 0, []
        for store, idx in parts:
            n = int(idx.numel())
            kept.append((store, idx[:max(n // 2, 1)]))
            keep_w.append(wts[pos:pos + max(n // 2, 1)])
            pos += n
        return step(kept, torch.cat(keep_w), stage, lrs)

    trainer._step = halved


def control(plan, seed, work: Path, device, net) -> dict:
    """Readings of the check's numbers, and of those it leaves aside, for
    the control (the reference in float8, forward and backward, in the
    program's place), for a planted fault (half of every batch left out)
    and for the program, on the inputs of a run with ``seed``: two set-ups
    and no window (``control.py --readings``)."""
    run = Run(plan, seed, work, device, net)
    run.setup()
    exact = run.reference()
    fp8 = run.reference(quant="fp8")
    faulty = Run(dict(plan, control="half_batch"), seed, work / "fault",
                 device, net)
    faulty.setup()
    out = {}
    for name, seen in (("control_fp8", fp8), ("fault_half_batch", faulty.seen),
                       ("program", run.seen)):
        out[name] = run.compare(seen, exact)
        out[f"{name}_aside"] = run.aside(seen, exact)
    return out
