"""The training loop: ``python -m sykepic_tpu_torch train config.ini`` (the
port of ``sykepic_tpu/train/loop.py``; reference ``sykepic/train/train.py``).

Keeps the contracts of the JAX package:

- INI sections ``[dataset] [model] [image] [train] [lr_warmup]
  [lr_reduction]`` with identical keys (``train.ini.example``),
- model-dir artifact: ``config.ini`` copy, ``class_names.txt``,
  ``class_distribution.csv``, ``best_state.msgpack`` (flax layout, read by
  both packages), ``train_stats.png`` (+zoomed, when matplotlib imports),
  ``test_report.txt``,
- best checkpoint on val-accuracy improvement, early stop on val-loss
  patience, a KeyboardInterrupt-tolerant loop that returns the best state,
- mid-training resume from ``train_state.pt`` (``torch.save`` of plain
  tensors and dicts, loadable with ``weights_only=True``): model, optimizer,
  LR schedule and best-metric bookkeeping.

The device is ``cuda`` unless ``--device cpu`` is asked for. The side
modes follow the JAX package (reference ``train.py:38-93``):
``--save-images DIR`` copies the split image sets and goes on;
``--dist FILE`` draws the class distribution and returns (matplotlib must
import); ``--collage ROWS COLUMNS PNG`` resizes one shuffled batch with K1's
eval form on the 0-255 scale on the device, augments it as the ``rotate``
route does (draws from a ``torch.Generator`` seeded 0) and saves the grid.

Under a process group (torchrun, or the spawn of ``train`` on a host with
several cards; :mod:`sykepic_tpu_torch.parallel`) every rank runs
:func:`main` on its own card: the same seed gives every rank the same split
and batch plans, the trainer splits each batch over the data mesh, and rank
0 alone writes the model directory, checkpoints, plots and reports and
prints. Every rank takes part in the collectives of a checkpoint
(``trainer.variables`` gathers sharded weights).
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

from .. import device as device_mod
from .. import parallel
from ..analyze import plot
from ..analyze.report import classification_report
from ..models import checkpoint, registry
from ..ops import augment as augment_ops
from ..ops import preprocess, resize_pad
from ..utils import logger
from . import config as config_mod
from . import data
from .input import BatchLoader
from .trainer import LRSchedule, Trainer

log = logger.get_logger("train")

TRAIN_STATE = "train_state.pt"


def _say(*args, **kwargs) -> None:
    """``print`` on rank 0 (every process without a group)."""
    if parallel.rank() == 0:
        print(*args, **kwargs)


def _from_rank0(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if not parallel.is_initialized():
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def rank_main(device, options: dict) -> None:
    """One rank of ``train``'s spawn over a host's cards (``python -m
    sykepic_tpu_torch train``): :func:`main` on ``device`` with the CLI's
    ``options`` (its parsed arguments as a dict). It lives here, and takes
    no function of ``__main__.py``: a spawned process cannot unpickle
    anything of a package's ``__main__`` module, which multiprocessing does
    not import again."""
    import argparse

    main(argparse.Namespace(**{**options, "device": str(device)}))


def side_mode(args) -> bool:
    """Whether ``args`` asks for ``--dist`` or ``--collage``: each runs in
    one process and trains nothing, whatever the cards."""
    return any(getattr(args, mode, None) for mode in ("dist", "collage"))


def main(args):
    config = config_mod.read_config(args.config)

    # [dataset] (reference train.py:22-36)
    dataset = Path(config.get("dataset", "path"))
    split = tuple(float(i) for i in config.get("dataset", "split").split(","))
    if (s := sum(split)) != 1.0:
        raise ValueError(f"Dataset split does not add up to 1.0. Got {s}")
    if len(split) < 2:
        raise ValueError("Dataset split needs to cover at least train and validation")
    test_split = len(split) == 3
    min_N = config.get("dataset", "min_N")
    min_N = int(min_N) if min_N else None
    max_N = config.get("dataset", "max_N")
    max_N = int(max_N) if max_N else None
    exclude = [n.strip() for n in config.get("dataset", "exclude").split(",") if n.strip()]
    random_seed = config.getint("dataset", "random_seed")
    model_data = data.ModelData(dataset, split, min_N, max_N, exclude, random_seed)

    if getattr(args, "save_images", None) and parallel.rank() == 0:
        _save_images(args.save_images, model_data, test_split)

    if getattr(args, "dist", None):
        if not plot.available():
            raise ImportError("train --dist draws with matplotlib, which "
                              "does not import here")
        out_file = Path(args.dist)
        if not out_file.suffix:
            out_file = out_file.with_suffix(".png")
        plot.dataset_distribution(model_data, out_file)
        print(f"[INFO] Distribution plot saved to {out_file}")
        return None

    device = device_mod.resolve(getattr(args, "device", None))
    if oversample_until := config.get("dataset", "oversample_until", fallback=""):
        model_data.oversample(int(oversample_until), None)
    elif decay := config.get("dataset", "oversample_with_decay", fallback=""):
        model_data.oversample(None, float(decay))

    # [image]
    batch_size = config.getint("image", "batch_size")
    num_workers = config.getint("image", "num_workers")
    spec = config_mod.get_preprocess_spec(config)
    augment_spec = config_mod.get_augment_spec(config)

    if getattr(args, "collage", None):
        return _collage(args.collage, model_data, spec, augment_spec,
                        num_workers, device)

    num_classes = model_data.num_classes
    external_test = config.get("dataset", "external_test", fallback="")

    # [model] (reference train.py:108-119)
    model_network = config.get("model", "network")
    model_id = config.get("model", "id")
    model_dir = Path(config.get("model", "path"))
    resume_requested = config.getboolean("train", "resume", fallback=False)
    if model_id == "auto":
        next_id = data.auto_id(model_network, model_dir)
        if resume_requested and next_id > 1:
            # resume targets the LATEST existing auto dir when it holds a
            # train state; otherwise `auto` would allocate a fresh empty
            # dir and the resume request would silently do nothing
            latest = model_dir / f"{model_network}_{next_id - 1}"
            if (latest / TRAIN_STATE).is_file():
                model_id = next_id - 1
            else:
                model_id = next_id
        else:
            model_id = next_id
    model_name = model_network
    if model_id:
        model_name += f"_{model_id}"
    model_dir = model_dir / model_name
    if parallel.rank() == 0:
        model_dir.mkdir(
            parents=True,
            exist_ok=config.getboolean("model", "exist_ok")
            or (resume_requested and model_dir.is_dir()),
        )
        model_data.save(model_dir)
        shutil.copy(args.config, model_dir / "config.ini")
    # the directory rank 0 chose and made (an auto id counts the dirs)
    model_dir = _from_rank0(model_dir)

    # [train]
    max_epochs = config.getint("train", "max_epochs")
    early_stop_patience = config.getint("train", "early_stop_patience")
    lr = config.getfloat("train", "learning_rate")
    optimizer = config.get("train", "optimizer")
    dtype_name = config.get("train", "dtype", fallback="float32")

    # model + (optionally) pretrained base weights; float32 parameters,
    # `[train] dtype` is the autocast compute dtype
    model, weights_spec = config_mod.get_network(config, num_classes)
    registry.init_weights(model, seed=random_seed)
    variables = checkpoint.load_pretrained(
        checkpoint.to_flax_variables(model.state_dict(), model_network),
        weights_spec, model_network,
        allow_random_init=config.getboolean("model", "allow_random_init",
                                            fallback=False))
    model.load_state_dict(checkpoint.from_flax_variables(
        variables, model.head.dropout_spec(), model_network))

    # [lr_warmup] / [lr_reduction]
    warmup = None
    if config.getboolean("lr_warmup", "use"):
        warmup = dict(
            factor_1=config.getfloat("lr_warmup", "factor_1"),
            factor_2=config.getfloat("lr_warmup", "factor_2"),
            step_1=config.getint("lr_warmup", "step_1"),
            step_2=config.getint("lr_warmup", "step_2"),
            step_3=config.getint("lr_warmup", "step_3"),
        )
    reduction = None
    if config.getboolean("lr_reduction", "use"):
        reduction = dict(
            factor=config.getfloat("lr_reduction", "factor"),
            patience=config.getint("lr_reduction", "patience"),
        )
    schedule = LRSchedule(lr, warmup, reduction)

    trainer = Trainer(
        model,
        optimizer=optimizer,
        preprocess_spec=spec,
        augment_kwargs=_augment_kwargs(augment_spec),
        seed=random_seed,
        device=device,
        dtype=dtype_name,
    )
    if trainer.mesh is not None:
        _say("[INFO] Mesh: " + ", ".join(
            f"{name}={size}" for name, size in
            zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape)))

    start_epoch = 1
    resume_metrics = None
    if resume_requested:
        resumed = load_train_state(model_dir, trainer)
        if resumed:
            start_epoch = int(resumed["epoch"]) + 1
            schedule.restore(resumed.get("schedule"))
            resume_metrics = resumed.get("metrics")
            _say(f"[INFO] Resuming training from epoch {start_epoch}")
        else:
            _say(f"[WARNING] resume requested but no {TRAIN_STATE} "
                 f"in {model_dir}; starting fresh")

    train_x, train_y = model_data.train_set()
    shrink = (spec.target_h, spec.target_w)
    # `[image] device_cache = auto|yes|no` (default auto): when the decoded
    # set fits the budget, upload it ONCE and drive epochs with index
    # batches (train/device_data.py); else the streaming host loader. The
    # budget check predicts the store bytes from PNG headers alone.
    device_cache = config.get("image", "device_cache", fallback="auto")
    cache_budget = config.getint(
        "image", "device_cache_mb", fallback=2048
    ) * 1024 * 1024
    use_cache = device_cache == "yes"
    if device_cache == "auto":
        from .device_data import estimate_nbytes

        est = (estimate_nbytes(train_x, spec)
               + estimate_nbytes(model_data.val_x, spec))
        use_cache = est <= cache_budget
    if use_cache:
        from .device_data import DeviceDataset

        # one whole store per card; batch sizes stay multiples of the data
        # axis, as the JAX package keeps them divisible by it
        cache_kw = dict(device=trainer.device,
                        num_threads=max(num_workers, 1),
                        batch_multiple=parallel.data_axis_size(trainer.mesh))
        train_loader = DeviceDataset(
            train_x, train_y, spec, batch_size, seed=random_seed,
            shuffle=True, **cache_kw,
        )
        val_loader = DeviceDataset(
            model_data.val_x, model_data.val_y, spec, batch_size, **cache_kw
        )
        _say(f"[INFO] Device-resident dataset: "
             f"{(train_loader.nbytes + val_loader.nbytes) / 1e6:.0f} MB "
             "uploaded once; epochs gather on device")
    else:
        # `[image] size_pool` (default 16): class-stratified size batching
        # granularity; 1 = reference-faithful plain global shuffle
        size_pool = config.getint("image", "size_pool", fallback=16)
        train_loader = BatchLoader(
            train_x, train_y, batch_size, shuffle=True, seed=random_seed,
            num_threads=max(num_workers, 1), pre_shrink_to=shrink,
            size_pool=size_pool,
        )
        val_loader = BatchLoader(
            model_data.val_x, model_data.val_y, batch_size,
            num_threads=max(num_workers, 1), pre_shrink_to=shrink,
            size_pool=size_pool,
        )

    best_state = train_net(
        trainer,
        train_loader,
        val_loader,
        schedule,
        max_epochs,
        early_stop_patience,
        model_dir,
        start_epoch=start_epoch,
        resume_metrics=resume_metrics,
    )
    trainer.set_variables(checkpoint.load_variables(best_state))

    classes = list(model_data.le.classes_)
    if test_split:
        test_loader = BatchLoader(
            model_data.test_x, model_data.test_y, batch_size,
            num_threads=max(num_workers, 1), pre_shrink_to=shrink,
        )
        report = test_net(trainer, test_loader, classes)
        _say(report)
        if parallel.rank() == 0:
            (model_dir / "test_report.txt").write_text(report)
    if external_test:
        x, y = data.external_eval_set(external_test, model_data)
        loader = BatchLoader(x, y, batch_size, num_threads=max(num_workers, 1))
        test_name = Path(external_test).name
        report = test_net(trainer, loader, classes, test_name=test_name)
        _say(report)
        if parallel.rank() == 0:
            (model_dir / f"test_report_{test_name}.txt").write_text(report)
    return model_dir


def _progress(iterable):
    """``tqdm`` around ``iterable`` when it imports (it is optional), on
    rank 0."""
    if parallel.rank() != 0:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        log.info("tqdm does not import: training runs without a progress "
                 "bar")
        return iterable
    return tqdm(iterable)


def train_net(
    trainer: Trainer,
    train_loader,
    val_loader,
    schedule: LRSchedule,
    max_epochs: int,
    early_stop_patience: int,
    model_dir,
    start_epoch: int = 1,
    resume_metrics: dict | None = None,
):
    """Epoch loop (reference ``train.py:201-320``). Returns the best
    checkpoint path, written (by rank 0) before any rank returns."""
    model_dir = Path(model_dir)
    main_rank = parallel.rank() == 0
    plots = plot.available() and main_rank
    if not plots and main_rank:
        log.info("matplotlib does not import: the training-curve plots "
                 "(train_stats.png) are skipped")
    # On resume the best-checkpoint/early-stop bookkeeping continues where
    # it left off; otherwise epoch 1 after a crash would overwrite a better
    # pre-crash best_state.msgpack.
    resume_metrics = resume_metrics or {}
    max_val_acc = float(resume_metrics.get("max_val_acc", 0.0))
    min_val_loss = float(resume_metrics.get("min_val_loss", float("inf")))
    no_improvement = int(resume_metrics.get("no_improvement", 0))
    train_accuracies, train_losses = [], []
    val_accuracies, val_losses = [], []
    best_state = model_dir / checkpoint.BEST_STATE

    try:
        for epoch in range(start_epoch, max_epochs + 1):
            _say(f"\n----- Epoch {epoch} -----")
            schedule.start_epoch(epoch)

            # Training phase. Metrics stay device scalars until the epoch
            # ends. A device-resident stratified set runs the whole epoch
            # in one call over its stacked batch plan (the same plan and
            # draws as the per-step loop).
            stacked = None
            if getattr(train_loader, "_use_mixed", False):
                stacked = train_loader.epoch_mixed_stacked(shuffle=True)
            if stacked is not None:
                loss_sum, acc_sum, n_sum = trainer.train_epoch_mixed(
                    *stacked, schedule.stage, schedule.lrs
                )
            else:
                loss_sum = acc_sum = n_sum = 0.0
                for batch in _progress(train_loader):
                    ls, cs, n = trainer.train_batch(batch, schedule.stage,
                                                    schedule.lrs)
                    loss_sum += ls
                    acc_sum += cs
                    n_sum += n
            train_acc = float(acc_sum) / float(n_sum)
            train_loss = float(loss_sum) / float(n_sum)
            train_accuracies.append(train_acc)
            train_losses.append(train_loss)
            _say(f"[STAT] Train Acc: {train_acc:.3f}, Train Loss: {train_loss:.3f}")

            # Validation phase
            loss_sum = acc_sum = n_sum = 0.0
            for batch in val_loader:
                ls, cs, n, _ = trainer.eval_batch(batch)
                loss_sum += ls
                acc_sum += cs
                n_sum += n
            val_acc = float(acc_sum) / float(n_sum)
            val_loss = float(loss_sum) / float(n_sum)
            val_accuracies.append(val_acc)
            val_losses.append(val_loss)
            _say(f"[STAT] Val Acc: {val_acc:.3f}, Val Loss: {val_loss:.3f}")

            # Checkpoint + plots (reference train.py:277-300)
            if plots:
                plot.plot_stats(
                    train_accuracies, train_losses, val_accuracies, val_losses,
                    outfile=model_dir / "train_stats.png",
                    first_epoch=1, epoch_step=3,
                )
                if epoch >= 11:
                    plot.plot_stats(
                        train_accuracies[10:], train_losses[10:],
                        val_accuracies[10:], val_losses[10:],
                        outfile=model_dir / "train_stats_zoomed.png",
                        first_epoch=11, epoch_step=2,
                    )
            if val_acc > max_val_acc:
                _say("[INFO] Increased accuracy, saving model state")
                max_val_acc = val_acc
                variables = trainer.variables  # every rank: a collective
                if main_rank:
                    checkpoint.save_variables(best_state, variables)

            if val_loss < min_val_loss or (epoch == start_epoch
                                           and not resume_metrics):
                no_improvement = 0
                min_val_loss = val_loss
            else:
                no_improvement += 1
                _say(f"[INFO] No reduction in loss for {no_improvement} epochs")
            early_stop = no_improvement >= early_stop_patience
            if not early_stop:
                schedule.end_epoch(epoch, val_loss)
            save_train_state(
                model_dir, trainer, epoch,
                metrics={
                    "max_val_acc": max_val_acc,
                    "min_val_loss": min_val_loss,
                    "no_improvement": no_improvement,
                },
                schedule=schedule,
            )
            if early_stop:
                _say("[INFO] Stopping early")
                break
    except KeyboardInterrupt:
        _say("[INFO] Stopping early")
    parallel.barrier()  # rank 0's writes are done: every rank sees them
    if not best_state.is_file():
        # No epoch improved: save the current state
        variables = trainer.variables
        if main_rank:
            checkpoint.save_variables(best_state, variables)
        parallel.barrier()
    return best_state


def test_net(trainer: Trainer, loader, classes, test_name=None) -> str:
    """Accuracy + the classification report (reference
    ``train.py:323-349``), in scikit-learn's layout
    (:func:`~sykepic_tpu_torch.analyze.report.classification_report`)."""
    if test_name:
        _say(f"\n----- Model Evaluation ({test_name}) -----")
    else:
        _say("\n----- Model Evaluation -----")
    true_labels: list[int] = []
    predicted_labels: list[int] = []
    acc_sum = n_sum = 0.0
    for batch in loader:
        ls, cs, n, preds = trainer.eval_batch(batch)
        acc_sum += float(cs)
        n_sum += float(n)
        real = batch.weights > 0
        true_labels.extend(np.asarray(batch.labels)[real].tolist())
        predicted_labels.extend(preds.cpu().numpy()[real].tolist())
    _say(f"[STAT] Test Accuracy: {acc_sum / n_sum:.3f}\n")
    return classification_report(true_labels, predicted_labels, classes)


def load_train_state(model_dir, trainer: Trainer):
    """Restore the model, optimizer state and bookkeeping from
    ``train_state.pt``. Returns the saved dict (with ``epoch``, ``metrics``
    and ``schedule``) or None."""
    path = Path(model_dir) / TRAIN_STATE
    if not path.is_file():
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    trainer.load_state_dict(state["model"])
    trainer.load_optimizer_state(state["opt_state"])
    return state


def save_train_state(model_dir, trainer: Trainer, epoch: int,
                     metrics: dict, schedule: LRSchedule) -> None:
    """Persist model + optimizer state + training bookkeeping for resume,
    as plain tensors and dicts (``torch.load(..., weights_only=True)``
    reads it). Every rank calls it (the state is gathered); rank 0
    writes."""
    state = {
        "model": {k: v.detach().cpu()
                  for k, v in trainer.state_dict().items()},
        "opt_state": trainer.optimizer_state(),
        "epoch": int(epoch),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "schedule": schedule.snapshot(),
    }
    if parallel.rank() != 0:
        return
    path = Path(model_dir) / TRAIN_STATE
    tmp = path.with_suffix(".tmp")
    torch.save(state, tmp)
    tmp.replace(path)


def _augment_kwargs(augment_spec):
    if not augment_spec.augmentations:
        return {}
    return augment_ops.spec_kwargs(
        augment_spec.augmentations,
        augment_spec.zoom_range,
        augment_spec.brightness_range,
        augment_spec.max_rotation,
    )


def _save_images(root, model_data, test_split: bool) -> None:
    """Copy the split image sets to disk (reference ``train.py:38-51``)."""
    root = Path(root)
    (root / "train").mkdir(exist_ok=True, parents=True)
    (root / "val").mkdir(exist_ok=True)
    for img_path in model_data.train_x:
        shutil.copy(img_path, root / "train" / img_path.name)
    for img_path in model_data.val_x:
        shutil.copy(img_path, root / "val" / img_path.name)
    if test_split:
        (root / "test").mkdir(exist_ok=True)
        for img_path in model_data.test_x:
            shutil.copy(img_path, root / "test" / img_path.name)


def collage_batch(batch, spec, augment_spec, device) -> np.ndarray:
    """One host batch as the collage shows it: ``(B, target_h, target_w)``
    float32 on the 0-255 scale. K1's eval form with ``raw`` resizes and pads
    it on ``device`` (its plain version on the CPU); with augmentations in
    the spec, :func:`~sykepic_tpu_torch.ops.augment.augment_batch` warps it
    with draws from a ``torch.Generator`` seeded 0, where the JAX package
    uses ``PRNGKey(0)`` (``sykepic_tpu/train/loop.py:613-653``)."""
    t_h, t_w = spec.target_h, spec.target_w
    new_h, new_w, pad_top, pad_left = preprocess.compute_geometry(
        batch.heights, batch.widths, t_h, t_w)
    border = preprocess.border_values(batch.canvas, batch.heights,
                                      batch.widths, spec.border)
    meta = torch.from_numpy(preprocess.slot_meta(
        batch.heights, batch.widths, new_h, new_w, pad_top, pad_left,
        border)).to(device)
    pixels = torch.from_numpy(np.ascontiguousarray(batch.canvas)).to(device)
    img = resize_pad.resize_pad(pixels, meta, t_h, t_w, 1, torch.float32,
                                raw=True)[..., 0]
    kwargs = _augment_kwargs(augment_spec)
    if kwargs:
        lim_x, lim_y = augment_ops.translate_limits(
            batch.heights, batch.widths, new_h, new_w, t_h, t_w)
        gen = torch.Generator(device=device).manual_seed(0)
        draws = augment_ops.draw_params(
            gen, len(batch.heights), torch.from_numpy(lim_x),
            torch.from_numpy(lim_y), device=device, **kwargs)
        img = augment_ops.augment_batch(img, draws, meta[9])
    return img.cpu().numpy()


def _collage(collage_args, model_data, spec, augment_spec, num_workers,
             device):
    """Save a grid of augmented training images (reference
    ``train.py:76-93``): one shuffled batch of ``ROWS x COLUMNS`` images
    through :func:`collage_batch`."""
    height, width, out_file = collage_args
    height, width = int(height), int(width)
    out_file = Path(out_file)
    if not out_file.suffix:
        out_file = out_file.with_suffix(".png")
    train_x, train_y = model_data.train_set()
    loader = BatchLoader(
        train_x, train_y, height * width, shuffle=True,
        num_threads=max(num_workers, 1),
    )
    batches = iter(loader)
    batch = next(batches)
    batches.close()  # stops the loader's producer thread
    img = collage_batch(batch, spec, augment_spec, device)
    plot.view_batch(img / 255.0, h=height, w=width, save=out_file)
    print(f"[INFO] Image collage saved to {out_file}")
    return out_file
