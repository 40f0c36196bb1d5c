"""CLI entry point: ``python -m sykepic_tpu_torch`` (the port of
``sykepic_tpu/__main__.py``).

The port carries the ``train``, ``prob`` and ``pipeline`` sub-commands,
with the JAX package's argument surface plus ``--device``::

    python -m sykepic_tpu_torch train CONFIG.ini [--device cuda|cpu]
    python -m sykepic_tpu_torch prob -r DIR -m MODEL -o OUT [-b N] [-f]
                                     [--device cuda|cpu]
    python -m sykepic_tpu_torch pipeline -r DIR -m MODEL -o OUT
                                     [--feat-out DIR] [-b N] [-w N] [-f]
                                     --device-features [--device cuda|cpu]

``pipeline`` runs only with ``--device-features`` (the fused on-device
pass); its host-thread mode, ``train``'s ``--save-images``/``--dist``/
``--collage`` and the other sub-commands are ROADMAP Queue 1 item 12.

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

    # pipeline (fused prob + feat in one pass)
    pipeline_parser = subparsers.add_parser(
        "pipeline",
        description="Fused single pass: probabilities AND features from one "
        "decode (--device-features: both computed on the device)",
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
        help="Feature-extraction threads of the host-thread mode (not "
        "ported yet), default is 8",
    )
    pipeline_parser.add_argument(
        "-f", "--force", action="store_true",
        help="Force overwrite of previous outputs",
    )
    pipeline_parser.add_argument(
        "--device-features", action="store_true",
        help="Extract geometry features on the device in the classification "
        "batch stream (chamfer-EDT biovolume; version tpu-dev-v1); the only "
        "mode ported so far",
    )
    pipeline_parser.add_argument(
        "--device", default="cuda",
        help="cuda (default; fails without a card) or cpu",
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


def _pipeline(args):
    from .compute import pipeline

    return pipeline.call(args)


if __name__ == "__main__":
    main()
