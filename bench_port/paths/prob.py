"""The ``prob`` path: archive reprocessing through
``compute/probability.py::process_samples_batched`` on one ``Classifier``.

Set-up writes the traffic's sample pool and a model directory from the
seed, loads the ``Classifier`` (``prepare_model``) and runs every job once,
which picks each dispatch shape's cuDNN algorithms and builds the kernels.
The window then runs the jobs in turn, each into an output tree of its own,
until ``seconds`` have passed; the job that crosses the end runs to its end
and counts, with the whole of its time.

The check, after the window: every CSV of every job holds exactly the ROI
ids the reference decodes from the sample, under the header ``roi,<class
names>``; and on ROIs drawn from the seed among all rows written, the gap
between each written probability and the plain reference's
(:mod:`bench_port.reference.prob`, float32 with TF32 off) is at most the
cell's limit ``max_abs_dp`` (``limits/<cell>.json``).

``plan["control"] = "tf32"`` puts the control in the program's place: the
check then compares the reference computed with TF32, as a ``.prob.csv``
would hold it, where it compares the written probabilities.
"""

from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .. import gen, tracing
from ..flops import shipped_pixels
from ..reference import ifcb as ref_ifcb
from ..reference import prob as ref_prob

CONTROLS = ("tf32",)


def first_rois(pool) -> list:
    """The ROIs of the pool's first sample, as the reference decodes
    them."""
    return [img for _, img in ref_ifcb.read_sample(pool[0]["path"])]


def csv_path(out_dir: Path, sample: str) -> Path:
    day = datetime.strptime(sample[1:16], "%Y%m%dT%H%M%S")
    return out_dir / f"{day:%Y/%m/%d}" / f"{sample}.prob.csv"


class Run:
    def __init__(self, plan, seed, work: Path, device, net):
        self.cfg, self.traffic = plan["cfg"], plan["traffic"]
        self.limits, self.seed = plan["limits"], seed
        self.work, self.device, self.net = work, device, net
        self.dtype = self.cfg["dtype"][self.traffic["path"]]
        self.target = self.cfg["image_shape"][1]
        self.control = plan.get("control")  # one of CONTROLS, or None

    def setup(self, trace: bool = False) -> None:
        from sykepic_tpu_torch.compute import probability

        self.probability = probability
        self.pool = gen.build_pool(self.work / "raw", self.traffic["pool"],
                                   self.seed)
        k = self.traffic["samples_per_job"]
        self.jobs = [self.pool[i:i + k] for i in range(0, len(self.pool), k)]
        self.params = gen.make_weights(self.net, self.cfg, self.seed,
                                       self.device, first_rois(self.pool))
        model_dir = gen.write_model_dir(self.work / "model", self.cfg,
                                        self.params)
        self.clf = probability.prepare_model(
            model_dir, batch_size=self.traffic["batch_size"],
            dtype=self.dtype, device=self.device)
        for i, job in enumerate(self.jobs):
            self._job(job, self.work / "warm" / str(i))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if trace:
            self.clf.timer = tracing.quiet_timer()

    def _job(self, job, out_dir: Path) -> None:
        self.probability.process_samples_batched(
            [s["path"] for s in job], self.clf, out_dir, force=True)

    def window(self, seconds: float) -> dict:
        self.done = []  # (job index, output tree) per job run
        t0 = time.perf_counter()
        while True:
            i = len(self.done) % len(self.jobs)
            out = self.work / "out" / str(len(self.done))
            self._job(self.jobs[i], out)
            self.done.append((i, out))
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        rois = sum(len(s["shapes"]) for i, _ in self.done
                   for s in self.jobs[i])
        pixels = sum(shipped_pixels(s["shapes"], self.target)
                     for i, _ in self.done for s in self.jobs[i])
        return {"e2e": {"rois_per_s": rois / elapsed},
                "tallies": {"rois": rois, "window_s": elapsed,
                            "jobs": len(self.done), "shipped_pixels": pixels,
                            "dtype": self.dtype, "net": self.net,
                            "stages": dict(self.clf.timer.totals)}}

    def memory_peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def free(self) -> None:
        del self.clf
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """``({name: (value, limit)}, attempted, failed)``."""
        header = "roi," + ",".join(self.cfg["class_names"])
        decoded = {}  # sample name -> [(roi id, image)] by the reference
        for s in self.pool:
            decoded[s["path"].name] = ref_ifcb.read_sample(s["path"])
        attempted = failed = bad_headers = 0
        rows = []  # (job run, sample, position) of every row due
        tables = {}  # (job run, sample) -> {roi id: csv line}
        for run, (i, out) in enumerate(self.done):
            for s in self.jobs[i]:
                name = s["path"].name
                want = [rid for rid, _ in decoded[name]]
                attempted += len(want)
                path = csv_path(out, name)
                lines = (path.read_text().splitlines() if path.is_file()
                         else [])
                if not lines or lines[0] != header:
                    bad_headers += 1
                got = {}
                for line in lines[1:]:
                    rid, _, rest = line.partition(",")
                    got[int(rid)] = rest
                failed += len(set(want) ^ set(got))
                tables[(run, name)] = got
                rows += [(run, name, j) for j in range(len(want))]
        rng = np.random.default_rng([self.seed, 1])
        picks = rng.choice(len(rows), min(self.traffic["check_rois"],
                                          len(rows)), replace=False)
        picked = [rows[j] for j in sorted(picks)]
        unique = sorted({(name, j) for _, name, j in picked})
        where = {key: k for k, key in enumerate(unique)}
        images = [decoded[name][j][1] for name, j in unique]
        ref = ref_prob.probabilities(images, self.params, self.net, self.cfg,
                                     self.device)
        if self.control == "tf32":
            placed = ref_prob.as_written(ref_prob.probabilities(
                images, self.params, self.net, self.cfg, self.device,
                allow_tf32=True))
        gap = 0.0
        for run, name, j in picked:
            rid = decoded[name][j][0]
            line = tables[(run, name)].get(rid)
            if line is None:
                continue  # counted as failed above
            written = (placed[where[(name, j)]] if self.control == "tf32"
                       else np.array(line.split(","), np.float64))
            gap = max(gap, float(np.abs(written - ref[where[(name, j)]])
                                 .max()))
        numbers = {"max_abs_dp": gap, "missing_or_extra_rows": failed,
                   "bad_headers": bad_headers}
        checks = {k: (v, self.limits[k]["limit"]) for k, v in numbers.items()}
        return checks, attempted, failed
