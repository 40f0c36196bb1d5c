"""The port's ``evaluate`` and ``frequency`` sub-commands and their modules
(``analyze/evaluation.py``, ``analyze/frequency.py``) against the JAX
package's on the same inputs: the repo's fixture sample with the selection
of ``tests/test_cli.py`` and randomized trees with selections drawn from a
numpy seed (``tests/torch_csv_trees.py``). Tolerance: exact. The CSVs and
the best-threshold files are byte-identical, the error paths raise the same
exceptions, and the frames are equal by
``assert_frame_equal(check_exact=True)``."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from torch_csv_trees import (CLASSES, FIXTURE_SAMPLE, ZERO, make_tree,
                             run_both)

TREES = ("fixture", "seed0", "seed1")


def _selections(t, seed):
    """``<sample>.select.csv`` files beside the tree: the fixture's two
    ROIs as ``tests/test_cli.py`` labels them, or random labels (the empty
    class among them) for every ROI of four non-empty samples."""
    d = t.root / "evals"
    d.mkdir()
    if t.names == [FIXTURE_SAMPLE]:
        (d / f"{FIXTURE_SAMPLE}.select.csv").write_text(
            "2,Uroglenopsis_sp\n3,unclassifiable\n")
        return d
    rng = np.random.default_rng(100 + seed)
    for name in [n for k, n in enumerate(t.names) if k != 2][:4]:
        rois = pd.read_csv(next(t.probs.rglob(f"{name}.prob.csv")))["roi"]
        labels = rng.choice(CLASSES, len(rois))
        (d / f"{name}.select.csv").write_text(
            "".join(f"{r},{lab}\n" for r, lab in zip(rois, labels)))
    return d


def _argmax_classes(t, n=2):
    """The ``n`` classes that win the argmax most often in the tree (the
    columns ``frequency --classes`` can keep at zero thresholds)."""
    probs = pd.concat(pd.read_csv(p, index_col=0)
                      for p in sorted(t.probs.rglob("*.csv")))
    return ",".join(probs.idxmax(axis=1).value_counts().index[:n])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    out = {}
    for k, kind in enumerate(TREES):
        t = make_tree(kind, root / kind)
        t.evals = _selections(t, k)
        t.columns = _argmax_classes(t)
        out[kind] = t
    return out


def _assert_same(result, expect_error=None):
    (j_err, j_files), (p_err, p_files) = result["jax"], result["port"]
    assert p_err is j_err is expect_error
    assert p_files == j_files
    return p_files


EVALUATE = {
    "fixed": lambda t, o: ["evaluate", t.evals, t.probs, "-t", t.thresholds,
                           "-o", o / "scores.csv"],
    "fixed_zero": lambda t, o: ["evaluate", t.evals, t.probs, "-t", t.zero,
                                "-o", o / "scores.csv"],
    "fixed_empty_class": lambda t, o: ["evaluate", t.evals, t.probs,
                                       "-t", t.thresholds,
                                       "--empty", "Class_A",
                                       "-o", o / "scores.csv"],
    "fixed_one_file": lambda t, o: ["evaluate",
                                    sorted(t.evals.iterdir())[0], t.probs,
                                    "-t", t.thresholds,
                                    "-o", o / "scores.csv"],
    "search_best_out": lambda t, o: ["evaluate", t.evals, t.probs,
                                     "--search", "-p", "0.1",
                                     "-o", o / "scores.csv",
                                     "--best-out", o / "best.txt"],
    "search_precision_criteria": lambda t, o: [
        "evaluate", t.evals, t.probs, "--search", "-p", "0.25",
        "--criteria", "precision", "-o", o / "scores.csv",
        "--best-out", o / "best.txt"],
    "search_fine_grid": lambda t, o: ["evaluate", t.evals, t.probs,
                                      "--search", "-p", "0.02",
                                      "-o", o / "sub" / "scores.csv"],
    "search_ignore": lambda t, o: ["evaluate", t.evals, t.probs, "--search",
                                   "--ignore", "Class_C,Uroglenopsis_sp",
                                   "-o", o / "scores.csv",
                                   "--best-out", o / "best.txt"],
}


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("case", sorted(EVALUATE))
def test_evaluate_writes_the_jax_bytes(trees, tree, case, tmp_path):
    files = _assert_same(run_both(lambda o: EVALUATE[case](trees[tree], o),
                                  tmp_path))
    scores = [f for f in files if f.endswith("scores.csv")]
    assert len(scores) == 1 and files[scores[0]]
    if "best.txt" in files:
        from sykepic_tpu_torch.compute.prediction import threshold_dictionary

        best = threshold_dictionary(tmp_path / "port" / "best.txt")
        assert best and all(0.0 <= v <= 1.0 for v in best.values())


FREQUENCY = {
    "zero": lambda t, o: ["frequency", t.probs, "-t", t.zero,
                          "-o", o / "freq.csv"],
    "default_thresholds": lambda t, o: ["frequency", t.probs,
                                        "-o", o / "f" / "freq.csv"],
    "thresholds": lambda t, o: ["frequency", t.probs, "-t", t.thresholds,
                                "-o", o / "freq.csv"],
    "top": lambda t, o: ["frequency", t.probs, "--top", "2",
                         "-o", o / "freq.csv"],
    "classes": lambda t, o: ["frequency", t.probs, "-t", t.zero,
                             "--classes", t.columns, "-o", o / "freq.csv"],
    "classes_top": lambda t, o: ["frequency", t.probs, "-t", t.zero,
                                 "--classes", t.columns, "--top", "1",
                                 "-o", o / "freq.csv"],
    "window": lambda t, o: ["frequency", t.probs, "-t", t.zero,
                            "--start", "2018-07-12 00:00" if t.names[0]
                            .startswith("D2018") else "2021-06-12 00:00",
                            "--end", "2018-07-13 00:00" if t.names[0]
                            .startswith("D2018") else "2021-07-01 00:00",
                            "-o", o / "freq.csv"],
    "start_top": lambda t, o: ["frequency", t.probs, "--top", "3",
                               "--start", "2018-01-01 00:00",
                               "-o", o / "freq.csv"],
    "hour_window": lambda t, o: ["frequency", t.probs, "-t", t.zero,
                                 "--hour-window", "05:00-08:30",
                                 "-o", o / "freq.csv"],
}


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("case", sorted(FREQUENCY))
def test_frequency_writes_the_jax_bytes(trees, tree, case, tmp_path):
    files = _assert_same(run_both(lambda o: FREQUENCY[case](trees[tree], o),
                                  tmp_path))
    (name, body), = files.items()
    table = pd.read_csv(tmp_path / "port" / name, index_col=0)
    # the fixture's two ROIs pass none of thresholds-2021.txt
    assert len(table) >= (case != "thresholds" or tree != "fixture")
    assert table.shape[1] <= TOP.get(case, len(CLASSES) + 50)


TOP = {"top": 2, "classes_top": 1, "start_top": 3}  # each case's --top


def test_frequency_counts_the_classified_rois(trees, tmp_path):
    """``tests/test_cli.py``'s frequency checks, on the port: one row for
    the fixture's one timestamp, two classified ROIs."""
    from sykepic_tpu_torch.__main__ import main

    out = tmp_path / "freq.csv"
    main(["frequency", str(trees["fixture"].probs), "-t", str(ZERO),
          "-o", str(out)])
    table = pd.read_csv(out, index_col=0)
    assert len(table) == 1 and table.sum().sum() == 2


ERRORS = {
    "frequency_empty_window": (SystemExit, lambda t, o: [
        "frequency", t.probs, "-o", o / "x.csv",
        "--start", "2030-01-01 00:00"]),
    "frequency_not_a_directory": (FileNotFoundError, lambda t, o: [
        "frequency", t.root / "missing", "-o", o / "x.csv"]),
    "evaluate_best_out_without_search": (SystemExit, lambda t, o: [
        "evaluate", t.evals, t.probs, "-t", t.zero, "-o", o / "s.csv",
        "--best-out", o / "b.txt"]),
    "evaluate_thresholds_and_search": (SystemExit, lambda t, o: [
        "evaluate", t.evals, t.probs, "-t", t.zero, "--search",
        "-o", o / "s.csv"]),
    "evaluate_neither_thresholds_nor_search": (SystemExit, lambda t, o: [
        "evaluate", t.evals, t.probs, "-o", o / "s.csv"]),
    "evaluate_no_selection_files": (FileNotFoundError, lambda t, o: [
        "evaluate", t.probs, t.probs, "-t", t.zero, "-o", o / "s.csv"]),
    "evaluate_missing_predictions": (StopIteration, lambda t, o: [
        "evaluate", t.evals, t.feats, "-t", t.zero, "-o", o / "s.csv"]),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_paths(trees, case, tmp_path):
    error, argv_of = ERRORS[case]
    _assert_same(run_both(lambda o: argv_of(trees["seed0"], o), tmp_path),
                 error)


def _modules(name):
    import importlib

    return (importlib.import_module(f"sykepic_tpu.analyze.{name}"),
            importlib.import_module(f"sykepic_tpu_torch.analyze.{name}"))


@pytest.mark.parametrize("tree", ("seed0", "seed1"))
@pytest.mark.parametrize("search", (False, True))
def test_evaluation_frames_equal_the_jax_frames(trees, tree, search):
    jax_mod, port_mod = _modules("evaluation")
    t = trees[tree]
    kwargs = (dict(threshold_search=True, search_precision=0.05)
              if search else dict(thresholds=str(t.thresholds)))
    want = jax_mod.parse_evaluations(t.evals, t.probs, **kwargs)
    got = port_mod.parse_evaluations(t.evals, t.probs, **kwargs)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    if search:
        for criteria in ("F1", "precision", "recall"):
            pd.testing.assert_frame_equal(
                port_mod.best_thresholds(got, criteria),
                jax_mod.best_thresholds(want, criteria), check_exact=True)


@pytest.mark.parametrize("seed", range(3))
def test_scores_match_jax(seed):
    jax_mod, port_mod = _modules("evaluation")
    rng = np.random.default_rng(seed)
    for counts in rng.integers(0, 5, (40, 4)):
        np.testing.assert_array_equal(
            port_mod.classification_scores(*counts),
            jax_mod.classification_scores(*counts))
    for p, a in (("x", "x"), ("x", "e"), ("e", "x"), ("x", "y")):
        assert (port_mod.classification_result(p, a, "e")
                == jax_mod.classification_result(p, a, "e"))


@pytest.mark.parametrize("tree", ("seed0", "seed1"))
def test_frequency_frames_equal_the_jax_frames(trees, tree):
    jax_mod, port_mod = _modules("frequency")
    t = trees[tree]
    for kwargs in (dict(thresholds=0.4),
                   dict(thresholds=0.0, start="2021-06-10 00:00",
                        end="2021-06-30 00:00"),
                   dict(thresholds=0.0, hour_window="05:00-09:00")):
        want = jax_mod.frequency_df(t.probs, **kwargs)
        got = port_mod.frequency_df(t.probs, **kwargs)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        pd.testing.assert_frame_equal(port_mod.filter_df(got, top=2),
                                      jax_mod.filter_df(want, top=2),
                                      check_exact=True)
