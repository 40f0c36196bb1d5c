"""The multi-process dry run: the port's counterpart of
``__graft_entry__.py::dryrun_multichip`` (``:53-331``), hermetic on the CPU.

``run(n)`` starts ``n`` processes joined by gloo through a ``FileStore``
(one rank a simulated card) and runs every leg of the JAX dry run on a mesh
of them: a ``("data", "model")`` mesh of ``n/2 x 2`` where ``n >= 4`` is
even, else ``("data",)``. It runs the same legs again in this process
without a group (one device), and holds the ranks' results against that
run:

- trainer (ResNet18, head 64, 8 classes, 32x32, Adam, every augmentation
  on, stage 2): one host-batch step (loss relative < 2e-3, ``:166``;
  parameters max |diff| < 5e-3, ``:180``), an eval step, then the
  device-resident store legs (``:186-237``): a gathered step, a mixed step
  over two stores whose total the world size does not divide, and a
  two-step whole-epoch call, held to the same bounds after them (running
  statistics too);
- a second trainer without augmentation, one mixed step over the two
  stores: the leg the tests also hold against the JAX ``Trainer``;
- on a mesh with a ``model`` axis, the sharded eval forward of ResNet18,
  ResNeXt50 (grouped convolutions) and ConvNeXt-tiny against the same
  network unsharded, within 2e-5 relative and 2e-6 absolute, as
  ``tests/test_parallel_tp.py`` holds JAX's;
- inference on the fixture sample with a 64x64, 8-class model directory:
  ``prob`` (shelf packing) through ``Classifier(mesh=)``,
  probabilities within 1.2e-5 (``:293``) with the same ids and argmax; the
  fused ``pipeline --device-features`` pass, features within 1e-5
  relative (``:316``).

Run it with ``python -m sykepic_tpu_torch.parallel.dryrun [N ...]``
(default 2 3 4); it prints one JSON line a world size and raises on a
bound that does not hold. Like every entry point of the port it runs on
the cards unless asked for the CPU: the ranks are cards joined by NCCL
(rank ``i`` on ``cuda:i``, the one-device run on ``cuda:0``), the kernels
launched instead of their plain versions, and it raises without enough
cards. ``--device cpu`` runs the ranks as gloo processes.
"""

from __future__ import annotations

import configparser
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent.parent
FIXTURE = REPO / "tests/data/raw/valid/D20180712T065600_IFCB114"
MODEL_SRC = REPO / "tests/model/resnet18_ref"
TARGET = 32
CLASSES = 8
LRS = (1e-3, 1e-4, 1e-5)
AUGMENT = dict(flip=True, translate=True, zoom=True, rotate=True,
               brightness=True, zoom_range=(0.8, 1.2),
               brightness_range=(0.95, 1.1), max_rotation=10)
BOUNDS = {"loss_rel": 2e-3, "param_max": 5e-3, "prob_max": 1.2e-5,
          "feat_rel": 1e-5}


def host_batch(n_devices: int):
    """The JAX dry run's batch (``__graft_entry__.py:121-140``): ragged
    random ROIs in 64x128 canvases, ``n * max(2, ceil(8 / n))`` of them."""
    batch_size = n_devices * max(2, -(-8 // n_devices))
    rng = np.random.default_rng(0)
    canvas = np.zeros((batch_size, 64, 128), np.uint8)
    heights = np.zeros(batch_size, np.int32)
    widths = np.zeros(batch_size, np.int32)
    for i in range(batch_size):
        h, w = int(rng.integers(16, 64)), int(rng.integers(16, 128))
        canvas[i, :h, :w] = rng.integers(0, 255, (h, w), np.uint8)
        heights[i], widths[i] = h, w
    labels = rng.integers(0, CLASSES, batch_size).astype(np.int32)
    return canvas, heights, widths, labels


def seeded_model():
    """ResNet18 with a 64-wide head and 8 classes, seeded weights."""
    from ..models import registry

    return registry.init_weights(
        registry.build_model("resnet18", CLASSES, head=(64,)), seed=0)


def build_model_dir(root: Path, model=None) -> Path:
    """The dry run's inference model directory: the repo's config at
    3x64x64 with a 64-wide head, 8 classes, the weights of ``model``
    (:func:`seeded_model` by default; flax-layout msgpack, which the JAX
    package reads too)."""
    from ..models import checkpoint

    mdir = Path(root) / "model"
    mdir.mkdir(parents=True, exist_ok=True)
    ini = configparser.ConfigParser()
    ini.read(MODEL_SRC / "config.ini")
    ini["image"]["shape"] = "3, 64, 64"
    ini["model"]["head"] = "64"
    with open(mdir / "config.ini", "w") as fh:
        ini.write(fh)
    (mdir / "class_names.txt").write_text(
        "\n".join(f"class_{i}" for i in range(CLASSES)))
    model = seeded_model() if model is None else model
    checkpoint.save_variables(mdir / "best_state.msgpack",
                              checkpoint.to_flax_variables(
                                  model.state_dict(), "resnet18"))
    return mdir


def mesh_for(n: int):
    """The JAX dry run's mesh choice (``__graft_entry__.py:100-104``)."""
    from . import data_mesh, data_model_mesh

    if n >= 4 and n % 2 == 0:
        return data_model_mesh(2)
    return data_mesh()


def _stores(device, spec, n: int):
    from ..train.device_data import device_store, make_store

    canvas, heights, widths, labels = host_batch(n)
    store = device_store(make_store(canvas, heights, widths, labels, spec),
                         device)
    store2 = device_store(make_store(
        canvas[:, :32, :64], np.minimum(heights, 32), np.minimum(widths, 64),
        labels, spec), device)
    return store, store2


def legs(device, mesh, out_dir: Path, n: int, lead: bool = True) -> None:
    """Every leg on ``device`` (under ``mesh``, or alone with None); ``n``
    sizes the batches as the JAX dry run sizes them for ``n`` devices.
    ``lead``: this rank writes the results into ``out_dir``."""
    import copy

    from .. import parallel
    from ..compute import pipeline, probability
    from ..train.config import PreprocessSpec
    from ..train.input import HostBatch
    from ..train.trainer import Trainer

    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    spec = PreprocessSpec(TARGET, TARGET, 3, border="mode")
    canvas, heights, widths, labels = host_batch(n)
    b = len(canvas)
    res: dict = {"mesh": {} if mesh is None else dict(
        zip(mesh.mesh_dim_names, mesh.mesh.shape))}

    seeded = seeded_model().to(device)
    if mesh is not None:
        # every rank trains from the mesh's first rank's weights
        parallel.replicate(mesh, seeded.state_dict())

    def model():
        return copy.deepcopy(seeded)

    # -- the trainer legs, every augmentation on
    t = Trainer(model(), "Adam", spec, AUGMENT, seed=0, device=device,
                mesh=mesh)
    if parallel.has_model_axis(mesh):
        # tp happens inside the library: the trainer saw the model axis
        res["sharded"] = sorted(parallel.sharded_names(t.model))
    hb = HostBatch(canvas, heights, widths, labels, np.ones(b, np.float32),
                   [None] * b)
    ls, _, k = t.train_batch(hb, 2, LRS)
    res["host"] = {"loss": float(ls), "n": float(k),
                   "state": _cpu(t.state_dict())}
    ls, c, k, preds = t.eval_batch(hb)
    res["eval"] = {"loss": float(ls), "correct": float(c), "n": float(k),
                   "preds": preds.cpu().numpy()}
    store, store2 = _stores(t.device, spec, n)
    idx = np.arange(b, dtype=np.int32)
    ls, _, k = t.train_batch_gathered(store, idx, np.ones(b, np.float32), 2,
                                      LRS)
    res["gathered"] = {"loss": float(ls), "n": float(k)}
    half = b // 2
    odd = max(half - 1, 1)  # a total the dry run's data axes do not divide
    ls, _, k = t.train_batch_mixed((store, store2), (idx[:half], idx[:odd]),
                                   np.ones(half + odd, np.float32), 2, LRS)
    res["mixed"] = {"loss": float(ls), "n": float(k)}
    ls, _, k = t.train_epoch_mixed(
        (store, store2), (np.stack([idx[:half], idx[:half]]),
                          np.stack([idx[:odd], idx[:odd]])),
        np.ones((2, half + odd), np.float32), 2, LRS)
    res["epoch"] = {"loss": float(ls), "n": float(k),
                    "state": _cpu(t.state_dict())}

    # -- one mixed Adam step without augmentation (held against JAX too)
    t = Trainer(model(), "Adam", spec, None, seed=0, device=device,
                mesh=mesh)
    ls, _, k = t.train_batch_mixed((store, store2), (idx[:half], idx[:odd]),
                                   np.ones(half + odd, np.float32), 2, LRS)
    res["plain"] = {"loss": float(ls), "n": float(k),
                    "state": _cpu(t.state_dict())}

    if parallel.has_model_axis(mesh):
        res["tp_forward"] = tp_forward(mesh, t.device)

    # -- inference: prob (shelf windows) and the fused pass (slot canvases)
    mdir = build_model_dir(out_dir.parent / f"model_{parallel.rank()}",
                           seeded)
    infer_bs = n * max(1, -(-4 // n))
    clf = probability.prepare_model(mdir, batch_size=infer_bs,
                                    device=device, mesh=mesh)
    probability.main([FIXTURE], mdir, out_dir / "prob_shelf", infer_bs,
                     force=True, progress_bar=False, classifier=clf)
    pipeline.main([FIXTURE], clf, out_dir / "fused", device_features=True,
                  force=True)
    if mesh is not None:
        try:
            probability.prepare_model(mdir, batch_size=infer_bs + 1,
                                      device=device, mesh=mesh)
        except ValueError as e:
            res["indivisible_batch"] = str(e)
    if lead:
        torch.save(res, out_dir / "legs.pt")


TP_NETS = (("resnet18", (64,)), ("resnext50_32x4d", (32,)),
           ("convnext_tiny", (32,)))


def tp_forward(mesh, device) -> dict:
    """``{network: worst |sharded - whole| / (2e-6 + 2e-5 |whole|)}`` over
    every rank's rows of an eval forward (1 is the bound). Weights are
    torch's default init from one seed on every rank; ConvNeXt's
    ``layer_scale`` is set to 0.5, so its blocks' sharded layers (at 1e-6
    they would vanish) weigh in the output."""
    import torch.distributed as dist

    from .. import parallel
    from ..models import registry

    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (8, 3, TARGET, TARGET)).astype(np.float32)).to(device)
    out = {}
    for name, head in TP_NETS:
        torch.manual_seed(1)
        m = registry.build_model(name, 5, head=head).to(device).eval()
        with torch.no_grad():
            for k, p in m.named_parameters():
                if k.endswith("layer_scale"):
                    p.fill_(0.5)
            whole = m(x)
            parallel.shard_wide_kernels(m, mesh)
            got = m(parallel.shard_batch(mesh, x))
            want = parallel.shard_batch(mesh, whole)
            worst = ((got - want).abs() / (2e-6 + 2e-5 * want.abs())).max()
        worst = worst.reshape(1)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        out[name] = float(worst)
    return out


def _cpu(state: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in state.items()
            if not k.endswith("num_batches_tracked")}


def _worker(device, n: int, out_dir: str) -> None:
    from .. import parallel

    legs(device, mesh_for(n), Path(out_dir), n, lead=parallel.rank() == 0)


def max_abs_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over the tensors of two state dicts (parameters and
    running statistics)."""
    if a.keys() != b.keys():
        raise AssertionError("the state dicts differ in their keys")
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def read_prob_csv(path: Path) -> dict:
    """``{roi id: probabilities}`` of a ``.prob.csv``."""
    rows = Path(path).read_text().splitlines()[1:]
    return {int(r.split(",")[0]): np.array([float(v) for v in
                                            r.split(",")[1:]])
            for r in rows}


def read_feat_csv(path: Path) -> dict:
    """``{roi id: feature values}`` of a ``.feat.csv``."""
    rows = [r for r in Path(path).read_text().splitlines()
            if r and not r.startswith("#")][1:]
    return {int(r.split(",")[0]): np.array([float(v) for v in
                                            r.split(",")[1:]])
            for r in rows}


def csv_paths(out_dir: Path, kind: str) -> list:
    return sorted(Path(out_dir, kind).rglob("*.csv"))


def compare(ref_dir: Path, got_dir: Path) -> dict:
    """The dry run's numbers of ``got_dir`` against the one-device run in
    ``ref_dir``; raises ``AssertionError`` past a bound."""
    ref = torch.load(Path(ref_dir) / "legs.pt", weights_only=False)
    got = torch.load(Path(got_dir) / "legs.pt", weights_only=False)
    out: dict = {"mesh": got["mesh"]}
    loss_rel = {}
    for leg in ("host", "gathered", "mixed", "epoch", "plain", "eval"):
        want, have = ref[leg]["loss"], got[leg]["loss"]
        if ref[leg]["n"] != got[leg]["n"]:
            raise AssertionError(f"{leg}: n {got[leg]['n']} != "
                                 f"{ref[leg]['n']}")
        loss_rel[leg] = abs(have - want) / max(abs(want), 1e-9)
    out["loss_rel"] = loss_rel
    out["param_max"] = {leg: max_abs_diff(ref[leg]["state"],
                                          got[leg]["state"])
                        for leg in ("host", "epoch", "plain")}
    out["eval_preds_equal"] = bool(np.array_equal(ref["eval"]["preds"],
                                                  got["eval"]["preds"]))
    prob = {}
    for path in csv_paths(ref_dir, "prob_shelf"):
        a = read_prob_csv(path)
        b = read_prob_csv(Path(got_dir) / path.relative_to(ref_dir))
        if a.keys() != b.keys() or not a:
            raise AssertionError(f"shelf: ROI ids {sorted(b)} != "
                                 f"{sorted(a)}")
        if any(np.argmax(a[r]) != np.argmax(b[r]) for r in a):
            raise AssertionError("shelf: argmax differs")
        prob["shelf"] = max(float(np.abs(a[r] - b[r]).max()) for r in a)
    out["prob_max"] = prob
    feat = 0.0
    for path in csv_paths(ref_dir, "fused"):
        if not path.name.endswith(".feat.csv"):
            continue
        a = read_feat_csv(path)
        b = read_feat_csv(Path(got_dir) / path.relative_to(ref_dir))
        if a.keys() != b.keys() or not a:
            raise AssertionError(f"fused: ROI ids {sorted(b)} != {sorted(a)}")
        feat = max(feat, max(float(np.max(np.abs(a[r] - b[r])
                                          / np.maximum(np.abs(a[r]), 1.0)))
                             for r in a))
    out["feat_rel"] = feat
    out["indivisible_batch"] = got.get("indivisible_batch")
    out["sharded"] = got.get("sharded")
    out["tp_forward"] = got.get("tp_forward")
    if out["tp_forward"] and max(out["tp_forward"].values()) > 1.0:
        raise AssertionError(f"sharded forward off: {out['tp_forward']}")
    worst = {"loss_rel": max(loss_rel.values()),
             "param_max": max(out["param_max"].values()),
             "prob_max": max(prob.values()), "feat_rel": feat}
    for k, bound in BOUNDS.items():
        if not worst[k] < bound:
            raise AssertionError(f"{k} {worst[k]:.3e} over the bound "
                                 f"{bound:.0e} on mesh {got['mesh']}")
    if got["mesh"] and out["indivisible_batch"] is None:
        raise AssertionError("an indivisible batch_size did not raise")
    return out


def run(n: int, work: Path, reference: Path | None = None,
        device: str = "cuda") -> dict:
    """The dry run at world size ``n`` (``n`` processes: NCCL on ``n``
    cards, or gloo on the CPU for ``device="cpu"``) against the one-device
    run in ``reference`` (made here under ``work`` when None). Returns
    :func:`compare`'s numbers; raises without ``n`` cards for cuda."""
    from .. import device as device_mod
    from . import spawn

    device = device_mod.resolve(device).type
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"world size {n} needs {n} cards; "
                           f"{torch.cuda.device_count()} visible")
    work = Path(work)
    if reference is None:
        reference = work / f"world1_for{n}"
        legs(device, None, reference, n)
    got = work / f"world{n}"
    spawn(_worker, n, device, args=(n, str(got)))
    return compare(reference, got)


def main(argv=None) -> int:
    import argparse
    import tempfile

    parser = argparse.ArgumentParser(prog="dryrun")
    parser.add_argument("sizes", nargs="*", type=int, default=[2, 3, 4])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; one card a rank) or cpu")
    args = parser.parse_args(argv)
    work = Path(tempfile.mkdtemp(prefix="sykepic-dryrun-"))
    try:
        for n in args.sizes:
            print(json.dumps({"world_size": n, "device": args.device,
                              **run(n, work, device=args.device)}),
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
