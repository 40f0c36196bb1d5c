"""CLI entry point: ``python -m sykepic_tpu_torch`` (the port of
``sykepic_tpu/__main__.py``).

The port carries the ``train``, ``prob``, ``feat``, ``pipeline``, ``watch``
and ``export`` sub-commands, with the JAX package's argument surface plus
``--device`` where the card is used::

    python -m sykepic_tpu_torch train CONFIG.ini [--device cuda|cpu]
    python -m sykepic_tpu_torch prob -r DIR -m MODEL -o OUT [-b N] [-f]
                                     [--device cuda|cpu]
    python -m sykepic_tpu_torch feat -r DIR -o OUT [-m MATLAB] [-p] [-f]
    python -m sykepic_tpu_torch pipeline -r DIR -m MODEL -o OUT
                                     [--feat-out DIR] [-b N] [-w N] [-f]
                                     [--device-features] [--device cuda|cpu]
    python -m sykepic_tpu_torch watch -r DIR -m MODEL -o OUT [--feat-out DIR]
                                     [-b N] [-i S] [--settle S]
                                     [--device cuda|cpu]
    python -m sykepic_tpu_torch export MODEL [-o FILE]

``feat`` and ``export`` run on the host and take no ``--device``.
``pipeline`` computes features on host threads beside the classification
on the card, or with ``--device-features`` on the card; ``watch`` runs the
host-thread ``pipeline`` over new samples. ``train``'s ``--save-images``/
``--dist``/``--collage`` and the pandas CSV sub-commands are not ported
yet (ROADMAP Queue 1 items 12d-12e).

Several cards (:mod:`sykepic_tpu_torch.parallel`): under ``torchrun
--nproc-per-node N`` every sub-command's ranks form one group (NCCL, each
rank on ``cuda:LOCAL_RANK``) and run on a data mesh over it; ``train`` with
the default ``--device cuda`` on a host with more than one visible card
starts one process per card by itself (``torch.multiprocessing.spawn``),
as the JAX trainer's default mesh spans every device. With one card
nothing changes.
"""

from __future__ import annotations

from argparse import ArgumentParser

from .utils import logger


def main(argv=None):
    logger.setup()
    parser = ArgumentParser(
        prog="sykepic-tpu-torch",
        description="Plankton image classification on an NVIDIA GPU "
        "(PyTorch/CUDA port of sykepic-tpu)",
    )
    from . import __version__

    parser.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    subparsers = parser.add_subparsers(
        title="available sub-commands",
        required=True,
        dest="sub-command",
        help="sykepic-tpu-torch {sub-command} -h for more information",
    )

    train_parser = subparsers.add_parser(
        "train", description="Train neural network classifiers"
    )
    train_parser.set_defaults(func=_train)
    train_parser.add_argument("config", help="Path to config file")
    train_parser.add_argument(
        "--collage", nargs=3, metavar=("ROWS", "COLUMNS", "PNG"),
        help="Save a ROWS x COLUMNS grid of transformed images to PNG "
        "(not ported yet)",
    )
    train_parser.add_argument(
        "--dist", metavar="FILE",
        help="Save a class distribution plot to FILE (not ported yet)")
    train_parser.add_argument(
        "--save-images", metavar="DIR",
        help="Extract train, test, val images to this path (not ported yet)")
    train_parser.add_argument(
        "--device", default="cuda",
        help="cuda (default; fails without a card) or cpu",
    )

    prob_parser = subparsers.add_parser(
        "prob", description="Calculate class probabilities"
    )
    prob_parser.set_defaults(func=_prob)
    prob_raw = prob_parser.add_mutually_exclusive_group(required=True)
    prob_raw.add_argument(
        "-r", "--raw", metavar="DIR", help="Root directory of raw IFCB data"
    )
    prob_raw.add_argument(
        "-s",
        "--samples",
        nargs="+",
        metavar="SAMPLE PATH",
        help="One or more sample paths (raw file without suffix)",
    )
    prob_raw.add_argument(
        "--image-dir", metavar="DIR", help="Root directory of images")
    prob_raw.add_argument(
        "--images", nargs="+", metavar="FILE",
        help="One or more image paths")
    prob_parser.add_argument("-m", "--model", required=True, help="Model directory")
    prob_parser.add_argument("-o", "--out", required=True, help="Root output directory")
    prob_parser.add_argument(
        "-b", "--batch-size", type=int, default=64, metavar="INT", help="Default is 64"
    )
    prob_parser.add_argument(
        "-w", "--num-workers", type=int, default=2, metavar="INT", help="Default is 2"
    )
    prob_parser.add_argument(
        "-f",
        "--force",
        action="store_true",
        help="Force overwrite of previous probabilities",
    )
    prob_parser.add_argument(
        "--device", default="cuda",
        help="cuda (default; fails without a card) or cpu",
    )

    # feat
    feat_parser = subparsers.add_parser("feat", description="Extract features")
    feat_parser.set_defaults(func=_feat)
    feat_raw = feat_parser.add_mutually_exclusive_group(required=True)
    feat_raw.add_argument(
        "-r", "--raw", metavar="DIR", help="Root directory of raw IFCB data"
    )
    feat_raw.add_argument(
        "-s",
        "--samples",
        nargs="+",
        metavar="SAMPLE PATH",
        help="One or more sample paths (raw file without suffix)",
    )
    feat_parser.add_argument(
        "-o", "--out", metavar="DIR", required=True, help="Root output directory"
    )
    feat_parser.add_argument(
        "-m",
        "--matlab",
        metavar="FILE",
        help="Matlab binary path (and use it instead of the native backend)",
    )
    feat_parser.add_argument(
        "-p", "--parallel", action="store_true", help="Use multiple cores"
    )
    feat_parser.add_argument(
        "-f",
        "--force",
        action="store_true",
        help="Force overwrite of previous features",
    )

    # pipeline (fused prob + feat in one pass)
    pipeline_parser = subparsers.add_parser(
        "pipeline",
        description="Fused single pass: probabilities AND features from one "
        "decode (the device classifies while host threads extract features; "
        "--device-features: both on the device)",
    )
    pipeline_parser.set_defaults(func=_pipeline)
    pipeline_raw = pipeline_parser.add_mutually_exclusive_group(required=True)
    pipeline_raw.add_argument(
        "-r", "--raw", metavar="DIR", help="Root directory of raw IFCB data"
    )
    pipeline_raw.add_argument(
        "-s", "--samples", nargs="+", metavar="SAMPLE PATH",
        help="One or more sample paths (raw file without suffix)",
    )
    pipeline_parser.add_argument("-m", "--model", required=True,
                                 help="Model directory")
    pipeline_parser.add_argument("-o", "--out", required=True,
                                 help="Probability output directory")
    pipeline_parser.add_argument(
        "--feat-out", metavar="DIR",
        help="Feature output directory (defaults to --out)",
    )
    pipeline_parser.add_argument(
        "-b", "--batch-size", type=int, default=256, metavar="INT",
        help="Default is 256",
    )
    pipeline_parser.add_argument(
        "-w", "--num-workers", type=int, default=8, metavar="INT",
        help="Feature-extraction threads, default is 8",
    )
    pipeline_parser.add_argument(
        "-f", "--force", action="store_true",
        help="Force overwrite of previous outputs",
    )
    pipeline_parser.add_argument(
        "--device-features", action="store_true",
        help="Extract geometry features on the device in the classification "
        "batch stream (chamfer-EDT biovolume; version tpu-dev-v1)",
    )
    pipeline_parser.add_argument(
        "--device", default="cuda",
        help="cuda (default; fails without a card) or cpu",
    )

    # watch (continuous monitoring daemon)
    watch_parser = subparsers.add_parser(
        "watch",
        description="Poll a raw directory and process new IFCB samples as "
        "they arrive (fused probabilities + features)",
    )
    watch_parser.set_defaults(func=_watch)
    watch_parser.add_argument(
        "-r", "--raw", required=True, metavar="DIR",
        help="Root directory of raw IFCB data",
    )
    watch_parser.add_argument("-m", "--model", required=True,
                              help="Model directory")
    watch_parser.add_argument("-o", "--out", required=True,
                              help="Probability output directory")
    watch_parser.add_argument(
        "--feat-out", metavar="DIR",
        help="Feature output directory (defaults to --out)",
    )
    watch_parser.add_argument(
        "-b", "--batch-size", type=int, default=256, metavar="INT",
        help="Default is 256",
    )
    watch_parser.add_argument(
        "-i", "--interval", type=float, default=30.0, metavar="SECONDS",
        help="Poll interval, default 30 s",
    )
    watch_parser.add_argument(
        "--settle", type=float, default=60.0, metavar="SECONDS",
        help="Process a sample only after its .roi has been idle this long",
    )
    watch_parser.add_argument(
        "--device", default="cuda",
        help="cuda (default; fails without a card) or cpu",
    )

    export_parser = subparsers.add_parser(
        "export",
        description="Export a trained model dir's checkpoint to a "
        "reference-loadable best_state.pth (torch state dict)",
    )
    export_parser.set_defaults(func=_export)
    export_parser.add_argument("model", help="Model directory")
    export_parser.add_argument(
        "-o", "--out", metavar="FILE",
        help="Output .pth path (default: <model>/best_state.pth)",
    )

    args = parser.parse_args(argv)
    return args.func(args)


def _train(args):
    import torch

    from . import parallel
    from .train import loop

    if parallel.launched_by_torchrun():
        args.device = str(parallel.init_process_group(args.device))
        try:
            return loop.main(args)
        finally:
            parallel.destroy_process_group()
    if (args.device == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        # the ranks get the plain options: a spawned process cannot
        # unpickle anything of this module (see loop.rank_main)
        options = {k: v for k, v in vars(args).items() if not callable(v)}
        parallel.spawn(loop.rank_main, torch.cuda.device_count(), "cuda",
                       args=(options,))
        return None
    return loop.main(args)


def _prob(args):
    from .compute import probability

    probability.call(args)


def _feat(args):
    from .compute import feature

    return feature.call(args)


def _pipeline(args):
    from .compute import pipeline

    return pipeline.call(args)


def _watch(args):
    from .compute import watch

    watch.call(args)


def _export(args):
    from .models import export

    print(f"Wrote {export.export(args.model, args.out)}")


if __name__ == "__main__":
    main()
