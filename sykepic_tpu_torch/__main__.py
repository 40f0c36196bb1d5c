"""CLI entry point: ``python -m sykepic_tpu_torch`` (the port of
``sykepic_tpu/__main__.py``).

The port carries every sub-command of the JAX package, with its argument
surface plus ``--device`` where the card is used::

    python -m sykepic_tpu_torch train CONFIG.ini [--device cuda|cpu]
                                     [--save-images DIR] [--dist FILE]
                                     [--collage ROWS COLUMNS PNG]
    python -m sykepic_tpu_torch prob -r DIR -m MODEL -o OUT [-b N] [-f]
                                     [--device cuda|cpu]
    python -m sykepic_tpu_torch feat -r DIR -o OUT [-m MATLAB] [-p] [-f]
    python -m sykepic_tpu_torch pipeline -r DIR -m MODEL -o OUT
                                     [--feat-out DIR] [-b N] [-w N] [-f]
                                     [--device-features] [--device cuda|cpu]
    python -m sykepic_tpu_torch watch -r DIR -m MODEL -o OUT [--feat-out DIR]
                                     [-b N] [-i S] [--settle S]
                                     [--device cuda|cpu]
    python -m sykepic_tpu_torch class PROBS [--feat DIR] -t FILE -o CSV
                                     [-d FILE] [-v FEATURE] [-a] [-f]
                                     [-exc FILE]
    python -m sykepic_tpu_torch size FEATS -g FILE -s FEATURE -o CSV
                                     [-v FEATURE] [-a] [-f] [--pixels-to-um3]
                                     [--volume] [-q] [-exc FILE]
    python -m sykepic_tpu_torch abundance PROBS --feat DIR -t FILE -o CSV
                                     [-v FEATURE] [-a] [-f] [-exc FILE]
    python -m sykepic_tpu_torch class_stats PROBS --feat DIR -t FILE -o CSV
                                     [--classes A,B] [-a] [-f]
    python -m sykepic_tpu_torch features_per_prediction PROBS --feat DIR
                                     -t FILE -o CSV [-a] [-f]
    python -m sykepic_tpu_torch evaluate EVALS PROBS (-t FILE | --search)
                                     -o CSV [-p STEP] [--best-out FILE]
                                     [--criteria F1] [--empty NAME]
                                     [--ignore A,B]
    python -m sykepic_tpu_torch frequency PROBS -o CSV [-t FILE]
                                     [--start T] [--end T] [--hour-window W]
                                     [--classes A,B] [--top N]
    python -m sykepic_tpu_torch export MODEL [-o FILE]

``feat``, ``export`` and the pandas CSV sub-commands (``class`` through
``frequency``) run on the host and take no ``--device``. ``pipeline``
computes features on host threads beside the classification on the card,
or with ``--device-features`` on the card; ``watch`` runs the host-thread
``pipeline`` over new samples. ``train --collage`` resizes one shuffled
batch with K1 on the card (``--device``, as ``train``).

Several cards (:mod:`sykepic_tpu_torch.parallel`): under ``torchrun
--nproc-per-node N`` the ranks of ``train``, ``prob`` and ``pipeline``
form one group (NCCL, each rank on ``cuda:LOCAL_RANK``) and run on a data
mesh over it; ``train`` with the default ``--device cuda`` on a host with
more than one visible card starts one process per card by itself
(``torch.multiprocessing.spawn``), as the JAX trainer's default mesh spans
every device. ``train --dist`` and ``--collage`` train nothing and run in
one process. With one card nothing changes.
"""

from __future__ import annotations

from argparse import ArgumentParser

from .utils import logger


def _list_of_strings(arg):
    return arg.split(",")


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
        help="Save a ROWS x COLUMNS grid of transformed images to PNG.",
    )
    train_parser.add_argument(
        "--dist", metavar="FILE",
        help="Save a class distribution plot to FILE")
    train_parser.add_argument(
        "--save-images", metavar="DIR",
        help="Extract train, test, val images to this path")
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

    # class
    class_parser = subparsers.add_parser(
        "class",
        description="Use thresholds together with probabilities for classification",
    )
    class_parser.set_defaults(func=_class)
    class_parser.add_argument("probabilities", help="Root directory of probabilities")
    class_parser.add_argument(
        "--feat", metavar="DIR", help="Root directory of features"
    )
    class_parser.add_argument(
        "-t", "--thresholds", metavar="FILE", required=True,
        help="Probability thresholds file (required)",
    )
    class_parser.add_argument(
        "-d", "--divisions", metavar="FILE", help="Feature divisions file (optional)"
    )
    class_parser.add_argument(
        "-o", "--out", metavar="FILE", required=True,
        help="Output CSV-file path (required)",
    )
    class_parser.add_argument(
        "-v", "--value-column", metavar="FEATURE", default="biomass_ugl",
        help="Feature used to aggregate results, default is biomass_ugl",
    )
    class_parser.add_argument(
        "-a", "--append", action="store_true",
        help="Append to output file if it exists",
    )
    class_parser.add_argument(
        "-f", "--force", action="store_true",
        help="Overwrite output file if it exists",
    )
    class_parser.add_argument(
        "-exc", "--exclusion_list", metavar="FILE",
        help="Text file containing a list of sample names to exclude",
    )

    # size
    size_parser = subparsers.add_parser("size", description="Extract size groups")
    size_parser.set_defaults(func=_size)
    size_parser.add_argument("features", help="Root directory of features")
    size_parser.add_argument(
        "-g", "--groups", metavar="FILE", required=True,
        help="Size group file (required)",
    )
    size_parser.add_argument(
        "-s", "--size-column", metavar="FEATURE", required=True,
        help="Feature used to determine groups (required)",
    )
    size_parser.add_argument(
        "-v", "--value-column", metavar="FEATURE", required=False,
        help="Feature used to aggregate results. Can be 'abundance'. "
             "Defaults to size-column.",
    )
    size_parser.add_argument(
        "-o", "--out", metavar="FILE", required=True,
        help="Output CSV-file path (required)",
    )
    size_parser.add_argument("-a", "--append", action="store_true",
                             help="Append to output file if it exists")
    size_parser.add_argument("-f", "--force", action="store_true",
                             help="Overwrite output file if it exists")
    size_parser.add_argument(
        "--pixels-to-um3", action="store_true",
        help="Convert pixels to um3 before determining size group",
    )
    size_parser.add_argument(
        "--volume", action="store_true", help="Include sample volume in output"
    )
    size_parser.add_argument(
        "-q", "--quiet", action="store_true", help="Don't display progress bar"
    )
    size_parser.add_argument(
        "-exc", "--exclusion_list", metavar="FILE",
        help="Text file containing a list of sample names to exclude",
    )

    # abundance
    abundance_parser = subparsers.add_parser(
        "abundance", description="Count class abundance"
    )
    abundance_parser.set_defaults(func=_abundance)
    abundance_parser.add_argument(
        "probabilities", help="Root directory of probabilities"
    )
    abundance_parser.add_argument(
        "--feat", metavar="DIR", help="Root directory of features"
    )
    abundance_parser.add_argument(
        "-t", "--thresholds", metavar="FILE", required=True,
        help="Probability thresholds file (required)",
    )
    abundance_parser.add_argument(
        "-o", "--out", metavar="FILE", required=True,
        help="Output CSV-file path (required)",
    )
    abundance_parser.add_argument(
        "-v", "--value-column", metavar="FEATURE", default="biomass_ugl",
        help="Feature used to aggregate results, default is biomass_ugl",
    )
    abundance_parser.add_argument("-a", "--append", action="store_true",
                                  help="Append to output file if it exists")
    abundance_parser.add_argument("-f", "--force", action="store_true",
                                  help="Overwrite output file if it exists")
    abundance_parser.add_argument(
        "-exc", "--exclusion_list", metavar="FILE",
        help="Text file containing a list of sample names to exclude",
    )

    # class_stats
    class_stats_parser = subparsers.add_parser(
        "class_stats", description="Calculate class statistics"
    )
    class_stats_parser.set_defaults(func=_class_stats)
    class_stats_parser.add_argument(
        "probabilities", help="Root directory of probabilities"
    )
    class_stats_parser.add_argument(
        "--feat", metavar="DIR", help="Root directory of features"
    )
    class_stats_parser.add_argument(
        "-t", "--thresholds", metavar="FILE", required=True,
        help="Probability thresholds file (required)",
    )
    class_stats_parser.add_argument(
        "-o", "--out", metavar="FILE", required=True,
        help="Output CSV-file path (required)",
    )
    class_stats_parser.add_argument(
        "--classes", type=_list_of_strings, metavar="list of strings",
        help="Comma-separated list of classes for which to calculate statistics",
    )
    class_stats_parser.add_argument("-a", "--append", action="store_true",
                                    help="Append to output file if it exists")
    class_stats_parser.add_argument("-f", "--force", action="store_true",
                                    help="Overwrite output file if it exists")

    # features_per_prediction
    fpp_parser = subparsers.add_parser(
        "features_per_prediction",
        description="Combine particle features with prediction",
    )
    fpp_parser.set_defaults(func=_features_per_prediction)
    fpp_parser.add_argument("probabilities", help="Root directory of probabilities")
    fpp_parser.add_argument("--feat", metavar="DIR",
                            help="Root directory of features")
    fpp_parser.add_argument(
        "-t", "--thresholds", metavar="FILE", required=True,
        help="Probability thresholds file (required)",
    )
    fpp_parser.add_argument(
        "-o", "--out", metavar="FILE", required=True,
        help="Output CSV-file path (required)",
    )
    fpp_parser.add_argument("-a", "--append", action="store_true",
                            help="Append to output file if it exists")
    fpp_parser.add_argument("-f", "--force", action="store_true",
                            help="Overwrite output file if it exists")

    # evaluate
    eval_parser = subparsers.add_parser(
        "evaluate",
        description="Score predictions against human-labeled "
        "*.select.csv evaluation files; optionally grid-search the "
        "F1-maximizing per-class thresholds (the library workflow behind "
        "reference thresholds-2021.txt files, analyze/evaluation.py)",
    )
    eval_parser.set_defaults(func=_evaluate)
    eval_parser.add_argument(
        "evaluations", metavar="EVALS",
        help="Evaluation file or directory of <sample>.select.csv files",
    )
    eval_parser.add_argument(
        "predictions", metavar="PROBS",
        help="Root directory of probability CSVs",
    )
    thres_group = eval_parser.add_mutually_exclusive_group(required=True)
    thres_group.add_argument(
        "-t", "--thresholds", metavar="FILE",
        help="Thresholds file to score with ('class value' lines)",
    )
    thres_group.add_argument(
        "--search", action="store_true",
        help="Grid-search per-class thresholds instead of scoring fixed ones",
    )
    eval_parser.add_argument(
        "-p", "--precision", type=float, default=0.01,
        help="Search grid step (default 0.01)",
    )
    eval_parser.add_argument(
        "-o", "--out", metavar="FILE", required=True,
        help="Output CSV of per-class scores (required)",
    )
    eval_parser.add_argument(
        "--best-out", metavar="FILE",
        help="With --search: also write the criteria-maximizing "
        "thresholds as a 'class value' file usable with -t elsewhere",
    )
    eval_parser.add_argument(
        "--criteria", default="F1",
        help="Column best thresholds maximize (default F1)",
    )
    eval_parser.add_argument(
        "--empty", default="unclassifiable",
        help="Name of the empty/unclassifiable class",
    )
    eval_parser.add_argument(
        "--ignore", type=_list_of_strings, default=None,
        help="Comma-separated class names to ignore",
    )

    # frequency
    freq_parser = subparsers.add_parser(
        "frequency",
        description="Class-frequency time series from a probability CSV "
        "tree (rows = sample timestamps, columns = classes, cells = "
        "classification counts); analyze/frequency.py as a CLI",
    )
    freq_parser.set_defaults(func=_frequency)
    freq_parser.add_argument(
        "predictions", metavar="PROBS",
        help="Root directory of probability CSVs",
    )
    freq_parser.add_argument(
        "-t", "--thresholds", metavar="FILE",
        help="Thresholds file ('class value' lines); default 0.0 for all",
    )
    freq_parser.add_argument(
        "-o", "--out", metavar="FILE", required=True,
        help="Output CSV-file path (required)",
    )
    freq_parser.add_argument("--start", help="Start 'YYYY-MM-DD HH:MM'")
    freq_parser.add_argument("--end", help="End 'YYYY-MM-DD HH:MM'")
    freq_parser.add_argument(
        "--hour-window", help="Daily hour-of-day window, e.g. '06:00-18:00'"
    )
    freq_parser.add_argument(
        "--classes", type=_list_of_strings, default=None,
        help="Comma-separated class columns to keep",
    )
    freq_parser.add_argument(
        "--top", type=int, default=None,
        help="Keep only the N most frequent classes",
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

    if loop.side_mode(args):
        return loop.main(args)  # one process: no group, no spawn
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


def _evaluate(args):
    from pathlib import Path

    from .analyze import evaluation

    if args.best_out and not args.search:
        raise SystemExit("--best-out requires --search")
    result = evaluation.parse_evaluations(
        args.evaluations,
        args.predictions,
        thresholds=args.thresholds,
        threshold_search=args.search,
        search_precision=args.precision,
        empty=args.empty,
        ignore=args.ignore,
    )
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    result.to_csv(out)
    print(f"Wrote {out}")
    if args.best_out:
        best = evaluation.best_thresholds(result, criteria=args.criteria)
        # search-mode frame is (class, threshold) multi-indexed
        lines = [
            f"{name} {float(thr):g}" for (name, thr), _ in best.iterrows()
        ]
        best_out = Path(args.best_out)
        best_out.parent.mkdir(parents=True, exist_ok=True)
        best_out.write_text("\n".join(lines) + "\n")
        print(f"Wrote {best_out}")


def _frequency(args):
    from pathlib import Path

    from .analyze import frequency
    from .compute.prediction import threshold_dictionary

    thresholds = (
        threshold_dictionary(args.thresholds) if args.thresholds else 0.0
    )
    df = frequency.frequency_df(
        args.predictions, thresholds,
        start=args.start, end=args.end, hour_window=args.hour_window,
    )
    if df is None:
        raise SystemExit(1)  # no samples in range (already printed)
    if args.classes or args.top:
        df = frequency.filter_df(df, prediction=args.classes, top=args.top)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(out)
    print(f"Wrote {out}")


def _class(args):
    from .compute import classification

    classification.main(args)


def _size(args):
    from .compute import size_group

    return size_group.call(args)


def _abundance(args):
    from .compute import abundance

    abundance.main(args)


def _class_stats(args):
    from .compute import class_stats

    class_stats.main(args)


def _features_per_prediction(args):
    from .compute import features_per_prediction

    features_per_prediction.main(args)


if __name__ == "__main__":
    main()
