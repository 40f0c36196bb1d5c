"""CLI entry point: ``python -m sykepic_tpu_torch`` (the port of
``sykepic_tpu/__main__.py``).

This slice of the port carries the ``prob`` sub-command, with the JAX
package's argument surface plus ``--device``::

    python -m sykepic_tpu_torch prob -r DIR -m MODEL -o OUT [-b N] [-f]
                                     [--device cuda|cpu]

The other sub-commands are ROADMAP slices 2, 3 and 5.
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
        "--image-dir", metavar="DIR",
        help="Root directory of images (not ported yet)")
    prob_raw.add_argument(
        "--images", nargs="+", metavar="FILE",
        help="One or more image paths (not ported yet)")
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

    args = parser.parse_args(argv)
    args.func(args)


def _prob(args):
    from .compute import probability

    probability.call(args)


if __name__ == "__main__":
    main()
