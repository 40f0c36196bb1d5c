"""Slice 5, multi-GPU, on the CPU: ``sykepic_tpu_torch.parallel`` against
the JAX package's ``sykepic_tpu/parallel`` and the JAX dry run's bounds.

Processes are spawned with gloo and a ``FileStore`` under ``tmp_path``
(``sykepic_tpu_torch.parallel.dryrun``, one thread a process), on
ResNet18 with a 64-wide head at 32x32:

- placement: the leaves that ``shard_wide_kernels`` shards are exactly
  those JAX's shards on an 8-device ``data_model_mesh(2)`` (each leaf's
  ``sharding.spec``), for resnet18, vgg16 (backbone replicated), a
  grouped-convolution net (resnext50_32x4d) and convnext_tiny, the
  behaviours of ``tests/test_parallel_tp.py``;
- the dry run at world sizes 2 and 3 (``("data",)``) and 4 (``2 x 2``):
  loss within 2e-3 relative and parameters and running statistics within
  5e-3 of the one-device run, probabilities within 1.2e-5 (the same ids
  and argmax), features within 1e-5 relative, an indivisible
  ``batch_size`` raising ``ValueError``; at 4 the trainer sharded the
  wide kernels by itself and the sharded forward of ResNet18, ResNeXt50
  and ConvNeXt equals the unsharded one;
- one Adam step without augmentation over two stores with a total that
  neither 2 nor 3 divides, at world sizes 2 and 3, against the JAX
  ``Trainer`` on the conftest's 8 virtual devices (loss, parameters and
  batch statistics within the dry run's bounds);
- ``prob`` at world size 2 against the JAX ``Classifier(mesh=)`` over two
  devices: the same ids and argmax, within 1.2e-5;
- ``python -m sykepic_tpu_torch train`` with several cards visible: the
  spawn it asks for, replayed on two gloo ranks.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sykepic_tpu import parallel as jax_parallel
from sykepic_tpu.compute import probability as jax_probability
from sykepic_tpu.compute.engine import Classifier as JaxClassifier
from sykepic_tpu.models.registry import build_model as jax_build
from sykepic_tpu.train import trainer as jax_trainer
from sykepic_tpu.train.config import PreprocessSpec as JaxSpec
from sykepic_tpu.train.device_data import make_store as jax_make_store
from sykepic_tpu_torch import parallel
from sykepic_tpu_torch.models import checkpoint, registry
from sykepic_tpu_torch.parallel import dryrun


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flax_paths_of(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_paths_of(v, prefix + (k,))
        else:
            yield prefix + (k,), v


PLACEMENT_NETS = {  # the networks and heads of tests/test_parallel_tp.py
    "resnet18": (10, (128, 64)),
    "vgg16": (6, (64,)),
    "resnext50_32x4d": (5, (32,)),
    "convnext_tiny": (5, (32,)),
}


@pytest.mark.parametrize("name", sorted(PLACEMENT_NETS))
def test_placement_equals_jax(name):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    classes, head = PLACEMENT_NETS[name]
    jmodel = jax_build(name, num_classes=classes, head=head)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 32, 32, 3)), train=False))
    # placement reads shapes alone: int8 zeros keep the replicas small
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.int8),
                          shapes["params"])
    mesh = jax_parallel.data_model_mesh(model_parallel=2,
                                        devices=jax.devices()[:8])
    placed = jax_parallel.shard_wide_kernels(params, mesh)
    want = {path for path, leaf in _flax_paths_of(placed)
            if leaf.sharding.spec and leaf.sharding.spec[-1] == "model"}
    model = registry.build_model(name, classes, head=head)
    paths = checkpoint.flax_paths(model.state_dict(), name)
    got = {paths[k][1:] for k, sharded in
           parallel.wide_kernel_placement(model, 2).items() if sharded}
    assert got == want and want
    assert len(dict(_flax_paths_of(placed))) == len(
        list(model.named_parameters()))
    if name == "vgg16":  # only the head shards (WIDE_MODULE_PATTERNS)
        assert {p[0] for p in got} == {"head"}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("dryrun")


@pytest.fixture(scope="module")
def worlds(work):
    """The dry run at world sizes 2, 3 and 4, each against the one-device
    run of its batch size (8 for 2 and 4, 9 for 3)."""
    refs = {}
    for n in (2, 3):
        refs[n] = work / f"world1_n{n}"
        dryrun.legs("cpu", None, refs[n], n)
    out = {n: dryrun.run(n, work, refs[3 if n == 3 else 2], device="cpu")
           for n in (2, 3, 4)}
    for n, numbers in out.items():
        print(json.dumps({"world_size": n, **numbers}))
    return out


@pytest.mark.parametrize("n", [2, 3, 4])
def test_dry_run_bounds(worlds, n):
    got = worlds[n]
    assert got["mesh"] == ({"data": 2, "model": 2} if n == 4
                           else {"data": n})
    assert max(got["loss_rel"].values()) < dryrun.BOUNDS["loss_rel"]
    assert max(got["param_max"].values()) < dryrun.BOUNDS["param_max"]
    assert max(got["prob_max"].values()) < dryrun.BOUNDS["prob_max"]
    assert set(got["prob_max"]) == {"shelf"}
    assert got["feat_rel"] < dryrun.BOUNDS["feat_rel"]
    assert got["eval_preds_equal"]
    # the dry run's inference batch (4, or 6 at 3) plus one
    bad, data = {2: (5, 2), 3: (7, 3), 4: (5, 2)}[n]
    assert got["indivisible_batch"] == (
        f"batch_size {bad} not divisible by the data mesh axis ({data})")


def test_tensor_parallel_at_four(worlds):
    got = worlds[4]
    model = dryrun.seeded_model()
    want = sorted(k for k, s in parallel.wide_kernel_placement(
        model, 2).items() if s)
    assert got["sharded"] == want and "head.0.weight" in want
    assert set(got["tp_forward"]) == {n for n, _ in dryrun.TP_NETS}
    assert max(got["tp_forward"].values()) <= 1.0


def _jax_mixed_step(n):
    """The JAX Trainer's mixed Adam step on the dry run's two stores."""
    jspec = JaxSpec(dryrun.TARGET, dryrun.TARGET, 3, border="mode")
    variables = checkpoint.to_flax_variables(
        dryrun.seeded_model().state_dict(), "resnet18")
    jmodel = jax_build("resnet18", num_classes=dryrun.CLASSES, head=(64,))
    jt = jax_trainer.Trainer(jmodel, variables, optimizer="Adam",
                             preprocess_spec=jspec, seed=0)
    canvas, heights, widths, labels = dryrun.host_batch(n)
    rep = NamedSharding(jt.mesh, P())

    def put(store):
        return {k: jax.device_put(v, rep) for k, v in store.items()}

    store = put(jax_make_store(canvas, heights, widths, labels, jspec))
    store2 = put(jax_make_store(canvas[:, :32, :64], np.minimum(heights, 32),
                                np.minimum(widths, 64), labels, jspec))
    b = len(canvas)
    half, idx = b // 2, np.arange(b, dtype=np.int32)
    odd = max(half - 1, 1)
    ls, _, k = jt.train_batch_mixed((store, store2), (idx[:half], idx[:odd]),
                                    np.ones(half + odd, np.float32), 2,
                                    dryrun.LRS)
    return float(ls), float(k), {"params": jax.device_get(jt.params),
                                 "batch_stats": jax.device_get(
                                     jt.batch_stats)}


@pytest.mark.parametrize("n", [2, 3])
def test_data_parallel_step_matches_jax(worlds, work, n):
    loss, k, want = _jax_mixed_step(n)
    assert k % n  # the total neither mesh divides
    got = torch.load(work / f"world{n}" / "legs.pt", weights_only=False)
    plain = got["plain"]
    assert plain["n"] == k
    rel = abs(plain["loss"] - loss) / abs(loss)
    flat_want = dict(_flax_paths_of(want))
    flat_got = dict(_flax_paths_of(checkpoint.to_flax_variables(
        plain["state"], "resnet18")))
    assert flat_got.keys() == flat_want.keys()
    diffs = {"params": 0.0, "batch_stats": 0.0}
    for path, v in flat_want.items():
        d = float(np.abs(np.asarray(v) - flat_got[path]).max())
        diffs[path[0]] = max(diffs[path[0]], d)
    print(json.dumps({"world_size": n, "vs_jax_loss_rel": rel,
                      "vs_jax_max_abs": diffs}))
    assert rel < dryrun.BOUNDS["loss_rel"]
    assert max(diffs.values()) < dryrun.BOUNDS["param_max"]


def test_engine_at_two_matches_jax_classifier(worlds, work, tmp_path):
    mdir = work / "model_0" / "model"
    jclf = JaxClassifier(mdir, batch_size=4,
                         mesh=jax_parallel.data_mesh(jax.devices()[:2]))
    out = tmp_path / "jax"
    jax_probability.main([dryrun.FIXTURE], mdir, out, 4, force=True,
                         progress_bar=False, classifier=jclf)
    (want_csv,) = dryrun.csv_paths(tmp_path, "jax")
    want = dryrun.read_prob_csv(want_csv)
    got_csv = work / "world2" / "prob_shelf" / want_csv.relative_to(out)
    got = dryrun.read_prob_csv(got_csv)
    assert got.keys() == want.keys() and len(got) == 2
    for r in got:
        assert np.argmax(got[r]) == np.argmax(want[r])
        assert float(np.abs(got[r] - want[r]).max()) <= 1.2e-5


def _cli_spawn(monkeypatch, argv, cards):
    """Run ``python -m sykepic_tpu_torch`` with ``argv`` as if ``cards``
    CUDA cards were visible, with ``parallel.spawn`` and ``loop.main``
    replaced by recorders; returns ``(spawns, mains)``: the spawn calls
    ``(fn, nprocs, device, args)`` and the namespaces ``loop.main`` got."""
    from sykepic_tpu_torch.__main__ import main
    from sykepic_tpu_torch.train import loop

    spawns, mains = [], []
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(parallel, "spawn", lambda fn, nprocs, device="cuda",
                        args=(): spawns.append((fn, nprocs, device, args)))
    monkeypatch.setattr(loop, "main", mains.append)
    main(argv)
    return spawns, mains


@pytest.mark.parametrize("cards", [1, 4])
def test_train_cli_spawns_one_rank_per_card(tmp_path, monkeypatch, cards):
    """``train`` on a host with several visible cards, not under torchrun,
    spawns ``loop.rank_main`` on every card with options that pickle by
    value (a spawned process cannot unpickle anything of ``__main__``);
    with one card, or ``--device cpu``, it runs ``loop.main`` itself."""
    import pickle

    from sykepic_tpu_torch.train.loop import rank_main

    spawns, mains = _cli_spawn(monkeypatch, ["train", "x.ini"], cards)
    if cards == 1:
        assert not spawns and [a.device for a in mains] == ["cuda"]
    else:
        ((fn, nprocs, device, (options,)),) = spawns
        assert (fn, nprocs, device) == (rank_main, 4, "cuda") and not mains
        assert options["config"] == "x.ini"
        assert pickle.loads(pickle.dumps(options)) == options
        assert not any(callable(v) for v in options.values())
    spawns, mains = _cli_spawn(monkeypatch,
                               ["train", "x.ini", "--device", "cpu"], cards)
    assert not spawns and [a.device for a in mains] == ["cpu"]


def test_train_cli_on_two_ranks(tmp_path, monkeypatch):
    """``python -m sykepic_tpu_torch train`` on a host with two visible
    cards: the spawn the CLI asks for (``loop.rank_main`` with the CLI's
    own options) replayed on two gloo ranks. One model directory, written
    by rank 0, with every artifact; the ranks stayed in step through the
    checkpoints' collectives and barriers."""
    from test_torch_train_loop import CONFIG, _dataset

    from sykepic_tpu_torch.compute import probability

    ini = tmp_path / "train.ini"
    ini.write_text(CONFIG.format(dataset=_dataset(tmp_path / "dataset"),
                                 models=tmp_path / "models", norm="no")
                   .replace("max_epochs = 2", "max_epochs = 1"))
    real_spawn = parallel.spawn
    with monkeypatch.context() as m:
        ((fn, nprocs, device, args),), _ = _cli_spawn(m, ["train", str(ini)], 2)
    assert (nprocs, device) == (2, "cuda")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch threads
    real_spawn(fn, nprocs, "cpu", args=args)
    (model_dir,) = (tmp_path / "models").iterdir()
    assert model_dir.name == "resnet18_1"
    for name in ("config.ini", "class_names.txt", "class_distribution.csv",
                 "best_state.msgpack", "train_state.pt", "test_report.txt"):
        assert (model_dir / name).is_file(), name
    state = torch.load(model_dir / "train_state.pt", weights_only=True)
    assert state["epoch"] == 1 and np.isfinite(state["metrics"]["min_val_loss"])
    clf = probability.prepare_model(model_dir, batch_size=4, device="cpu")
    rows = list(clf.classify_rois(
        (0, i, np.full((20, 30), 40 * i, np.uint8)) for i in range(1, 4)))
    assert len(rows) == 3 and all(np.isfinite(p).all() for _, _, p in rows)
