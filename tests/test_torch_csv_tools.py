"""The port's pandas CSV sub-commands (``class``, ``size``, ``abundance``,
``class_stats``, ``features_per_prediction``) against the JAX package's on
the same inputs: the repo's fixture sample and randomized trees made from
a numpy seed (``tests/torch_csv_trees.py``). Tolerance: exact. Every file
the port's CLI writes is byte-identical to the JAX CLI's, each error path
raises the same exception, and the modules' frames are equal by
``assert_frame_equal(check_exact=True)``."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from torch_csv_trees import (CLASSES, FEAT_COLUMNS, GROUPS, make_tree,
                             run_both)

TREES = ("fixture", "seed0", "seed1")
# the classes class_stats --classes picks in each kind of tree
STAT_CLASSES = {"fixture": "Licmophora_sp,Uroglenopsis_sp",
                "random": "Class_B,Nodularia_spumigena"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {kind: make_tree(kind, root / kind) for kind in TREES}


def _stat_classes(t):
    return STAT_CLASSES["fixture" if t.names[0].startswith("D2018")
                        else "random"]


CASES = {
    "class": lambda t, o: ["class", t.probs, "--feat", t.feats,
                           "-t", t.thresholds, "-o", o / "class.csv"],
    "class_probs_only": lambda t, o: ["class", t.probs, "-t", t.thresholds,
                                      "-o", o / "class.csv"],
    "class_divisions": lambda t, o: ["class", t.probs, "--feat", t.feats,
                                     "-t", t.thresholds, "-d", t.divisions,
                                     "-o", o / "class.csv"],
    "class_frequency": lambda t, o: ["class", t.probs, "--feat", t.feats,
                                     "-t", t.thresholds, "-v", "frequency",
                                     "-o", o / "class.csv"],
    "class_biovolume": lambda t, o: ["class", t.probs, "--feat", t.feats,
                                     "-t", t.thresholds,
                                     "-v", "biovolume_um3",
                                     "-o", o / "class.csv"],
    "class_exclusion": lambda t, o: ["class", t.probs, "--feat", t.feats,
                                     "-t", t.thresholds,
                                     "-exc", t.exclusion,
                                     "-o", o / "class.csv"],
    "abundance": lambda t, o: ["abundance", t.probs, "--feat", t.feats,
                               "-t", t.thresholds, "-o", o / "ab.csv"],
    "abundance_zero": lambda t, o: ["abundance", t.probs, "--feat", t.feats,
                                    "-t", t.zero, "-o", o / "ab.csv"],
    "abundance_exclusion": lambda t, o: ["abundance", t.probs,
                                         "--feat", t.feats,
                                         "-t", t.thresholds,
                                         "-exc", t.exclusion,
                                         "-o", o / "ab.csv"],
    "class_stats": lambda t, o: ["class_stats", t.probs, "--feat", t.feats,
                                 "-t", t.thresholds, "-o", o / "st.csv"],
    "class_stats_classes": lambda t, o: ["class_stats", t.probs,
                                         "--feat", t.feats, "-t", t.zero,
                                         "--classes", _stat_classes(t),
                                         "-o", o / "st.csv"],
    "features_per_prediction": lambda t, o: [
        "features_per_prediction", t.probs, "--feat", t.feats,
        "-t", t.thresholds, "-o", o / "fpp.csv"],
    "features_per_prediction_zero": lambda t, o: [
        "features_per_prediction", t.probs, "--feat", t.feats, "-t", t.zero,
        "-o", o / "fpp.csv"],
    "size_px_volume": lambda t, o: ["size", t.feats, "-g", t.groups,
                                    "-s", "biovolume_px", "--pixels-to-um3",
                                    "--volume", "-q", "-o", o / "size.csv"],
    "size_exclusion": lambda t, o: ["size", t.feats, "-g", t.groups,
                                    "-s", "biovolume_um3", "-v", "abundance",
                                    "-exc", t.exclusion, "-q",
                                    "-o", o / "size.csv"],
    "size_progress_bar": lambda t, o: ["size", t.feats, "-g", t.groups,
                                       "-s", "area", "-o", o / "size.csv"],
}


def _assert_same(result, expect_error=None):
    (j_err, j_files), (p_err, p_files) = result["jax"], result["port"]
    assert p_err is j_err is expect_error
    assert sorted(p_files) == sorted(j_files)
    for name in j_files:
        assert p_files[name] == j_files[name], name
    return p_files


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_writes_the_jax_bytes(trees, tree, case, tmp_path):
    files = _assert_same(run_both(lambda o: CASES[case](trees[tree], o),
                                  tmp_path))
    assert files and all(files.values())


@pytest.mark.parametrize("tree", ("fixture", "seed0"))
@pytest.mark.parametrize("value", FEAT_COLUMNS + ("abundance",))
def test_size_every_summary_feature(trees, tree, value, tmp_path):
    t = trees[tree]
    files = _assert_same(run_both(
        lambda o: ["size", t.feats, "-g", t.groups, "-s", "biovolume_um3",
                   "-v", value, "--volume", "-q", "-o", o / "size.csv"],
        tmp_path))
    table = pd.read_csv(tmp_path / "port" / "size.csv", index_col=0)
    groups = [line.split()[0] for line in t.groups.read_text().splitlines()]
    assert list(table.columns) == groups + ["total", "volume_ml"]
    assert len(table) == len(t.names)
    assert files


AGGREGATES = {
    "class": lambda t, out: ["class", t.probs, "--feat", t.feats,
                             "-t", t.thresholds, "-o", out],
    "size": lambda t, out: ["size", t.feats, "-g", GROUPS,
                            "-s", "biovolume_um3", "-q", "-o", out],
    "abundance": lambda t, out: ["abundance", t.probs, "--feat", t.feats,
                                 "-t", t.zero, "-o", out],
    "class_stats": lambda t, out: ["class_stats", t.probs, "--feat", t.feats,
                                   "-t", t.zero, "-o", out],
    "features_per_prediction": lambda t, out: [
        "features_per_prediction", t.probs, "--feat", t.feats, "-t", t.zero,
        "-o", out],
}


@pytest.mark.parametrize("mode", ("exists", "append", "force"))
@pytest.mark.parametrize("command", sorted(AGGREGATES))
def test_append_and_force(trees, command, mode, tmp_path):
    """The output-file rules of ``tests/test_append_semantics.py`` in both
    packages: an existing target needs ``--append`` (rows added, one
    header) or ``--force`` (overwritten). ``features_per_prediction``
    numbers its files, so its target never exists and a second run
    rewrites its chunks."""
    from sykepic_tpu.__main__ import main as jax_main
    from sykepic_tpu_torch.__main__ import main as port_main

    t = trees["seed0"]
    flag = {"exists": [], "append": ["-a"], "force": ["-f"]}[mode]
    out = "out.csv"

    def first(out_dir):
        main = jax_main if out_dir.name == "jax" else port_main
        main([str(a) for a in AGGREGATES[command](t, out_dir / out)])

    expect = (FileExistsError if mode == "exists"
              and command != "features_per_prediction" else None)
    files = _assert_same(run_both(
        lambda o: AGGREGATES[command](t, o / out) + flag, tmp_path,
        before=first), expect)
    name = "out1.csv" if command == "features_per_prediction" else out
    lines = files[name].decode().splitlines()
    header = lines[0]
    if mode == "append" and command != "features_per_prediction":
        assert lines.count(header) == 1
        rows = lines[1:]
        assert rows[:len(rows) // 2] == rows[len(rows) // 2:]
    else:
        assert lines.count(header) == 1


@pytest.mark.parametrize("command", sorted(AGGREGATES))
def test_output_must_be_a_csv(trees, command, tmp_path):
    _assert_same(run_both(
        lambda o: AGGREGATES[command](trees["fixture"], o / "out.txt"),
        tmp_path), ValueError)


def _misaligned(t, o):
    """A feat tree whose first sample is renamed: the pairs' stems
    differ."""
    feats = o.parent / f"feats_{o.name}"
    feats.mkdir()
    for k, p in enumerate(sorted(t.feats.rglob("*.csv"))):
        name = p.name.replace("IFCB114", "IFCB999") if k == 0 else p.name
        (feats / name).write_bytes(p.read_bytes())
    return feats


ERRORS = {
    "no_subcommand": (SystemExit, lambda t, o: []),
    "unknown_subcommand": (SystemExit, lambda t, o: ["nonsense"]),
    "class_without_thresholds": (SystemExit, lambda t, o: [
        "class", t.probs, "-o", o / "c.csv"]),
    "abundance_without_feat": (ValueError, lambda t, o: [
        "abundance", t.probs, "-t", t.zero, "-o", o / "a.csv"]),
    "class_stats_without_feat": (ValueError, lambda t, o: [
        "class_stats", t.probs, "-t", t.zero, "-o", o / "s.csv"]),
    "features_per_prediction_without_feat": (ValueError, lambda t, o: [
        "features_per_prediction", t.probs, "-t", t.zero, "-o", o / "f.csv"]),
    "size_unknown_column": (ValueError, lambda t, o: [
        "size", t.feats, "-g", t.groups, "-s", "no_such_feature", "-q",
        "-o", o / "s.csv"]),
    "size_unknown_value_column": (ValueError, lambda t, o: [
        "size", t.feats, "-g", t.groups, "-s", "area", "-v", "nope", "-q",
        "-o", o / "s.csv"]),
    "class_misaligned_trees": (ValueError, lambda t, o: [
        "class", t.probs, "--feat", _misaligned(t, o), "-t", t.thresholds,
        "-o", o / "c.csv"]),
    "abundance_misaligned_trees": (ValueError, lambda t, o: [
        "abundance", t.probs, "--feat", _misaligned(t, o), "-t", t.zero,
        "-o", o / "a.csv"]),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_paths(trees, case, tmp_path):
    error, argv_of = ERRORS[case]
    _assert_same(run_both(lambda o: argv_of(trees["seed1"], o), tmp_path),
                 error)


# -- the modules' frames -------------------------------------------------------

def _modules(name):
    import importlib

    jax_mod = importlib.import_module(f"sykepic_tpu.{name}")
    port_mod = importlib.import_module(f"sykepic_tpu_torch.{name}")
    return jax_mod, port_mod


def _csvs(root):
    return sorted(root.rglob("*.csv"))


def _chunks(frames):
    """Month chunks as one frame keyed by chunk number."""
    return pd.concat(frames, keys=range(len(frames)))


FRAMES = {
    "classification.class_df": lambda m, t: m.class_df(
        _csvs(t.probs), _csvs(t.feats), t.thresholds,
        divisions_file=t.divisions),
    "classification.class_df_probs_only": lambda m, t: m.class_df_probs_only(
        _csvs(t.probs), t.thresholds),
    "classification.swell_df": lambda m, t: m.swell_df(m.class_df(
        _csvs(t.probs), _csvs(t.feats), t.thresholds)),
    "abundance.class_df": lambda m, t: m.class_df(
        _csvs(t.probs), _csvs(t.feats), t.thresholds),
    "class_stats.class_df": lambda m, t: m.class_df(
        _csvs(t.probs), _csvs(t.feats), None, t.thresholds),
    "features_per_prediction.class_df": lambda m, t: _chunks(m.class_df(
        _csvs(t.probs), _csvs(t.feats), t.zero)),
    "size_group.size_table": lambda m, t: m.size_table(
        _csvs(t.feats), m.SizeGroups.from_file(t.groups), "biovolume_px",
        "area", px_to_um3=True, volume_info=True),
    "prediction.prediction_dataframe": lambda m, t: m.prediction_dataframe(
        _csvs(t.probs), t.thresholds),
}


@pytest.mark.parametrize("tree", ("seed0", "seed1"))
@pytest.mark.parametrize("what", sorted(FRAMES))
def test_frames_equal_the_jax_frames(trees, tree, what):
    module, _ = what.split(".")
    jax_mod, port_mod = _modules(f"compute.{module}")
    want = FRAMES[what](jax_mod, trees[tree])
    got = FRAMES[what](port_mod, trees[tree])
    assert len(got)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


@pytest.mark.parametrize("seed", range(4))
def test_predict_matches_jax(seed):
    """The masked argmax on random probabilities, ties included, with a
    thresholds dict that leaves classes out and with a scalar."""
    jax_mod, port_mod = _modules("compute.prediction")
    rng = np.random.default_rng(seed)
    probs = np.round(rng.dirichlet(np.ones(6) * 0.5, 300), 2)
    probs[:20, 1] = probs[:20, 2] = probs[:20].max(axis=1)  # ties
    classes = [f"c{k}" for k in range(6)]
    table = {c: float(v) for c, v in zip(classes[1:],
                                         rng.uniform(0.1, 0.8, 5))}
    for thresholds in (table, 0.3, 0):
        for got, want in zip(port_mod.predict(probs, classes, thresholds),
                             jax_mod.predict(probs, classes, thresholds)):
            np.testing.assert_array_equal(got, want)
    frame = pd.DataFrame(probs, columns=classes)
    for k in range(0, 300, 37):
        assert (port_mod.row_prediction(frame.iloc[k], table)
                == jax_mod.row_prediction(frame.iloc[k], table))
    got = port_mod.prediction_dataframe(frame.copy(), table)
    want = jax_mod.prediction_dataframe(frame.copy(), table)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_threshold_dictionary_matches_jax(tmp_path):
    jax_mod, port_mod = _modules("compute.prediction")
    f = tmp_path / "t.txt"
    f.write_text("a 0.5\n\nb\nc 0.25\n")
    assert (port_mod.threshold_dictionary(f, default=0.1)
            == jax_mod.threshold_dictionary(f, default=0.1)
            == {"a": 0.5, "b": 0.1, "c": 0.25})
    for mod in (port_mod, jax_mod):
        with pytest.raises(ValueError, match="no threshold"):
            mod.threshold_dictionary(f)
        with pytest.raises(ValueError, match="path, list of paths"):
            mod.prediction_dataframe(3)


@pytest.mark.parametrize("seed", range(3))
def test_divisions_and_size_groups_match_jax(seed):
    """Intra-class division binning (``np.searchsorted``, the JAX package's
    repair of the reference) and size-group assignment, values on the
    bounds included."""
    jax_c, port_c = _modules("compute.classification")
    jax_s, port_s = _modules("compute.size_group")
    rng = np.random.default_rng(seed)
    divisions = {"Class_B": [5000, 500], "Class_C": [1000]}
    preds = rng.choice(CLASSES[:4], 200)
    values = rng.choice([400.0, 500.0, 999.0, 1000.0, 5000.0, 7e3], 200)
    np.testing.assert_array_equal(
        port_c.divide_predictions(preds, values, divisions),
        jax_c.divide_predictions(preds, values, divisions))
    assert (port_c.names_of_divisions(divisions)
            == jax_c.names_of_divisions(divisions))
    bounds = sorted(rng.choice(np.arange(1, 5000), 4, replace=False))
    names = [f"g{k}" for k in range(4)]
    groups = [port_s.SizeGroups(names[::-1], bounds[::-1]),
              jax_s.SizeGroups(names[::-1], bounds[::-1])]
    sizes = np.concatenate([rng.uniform(0, 6000, 100), bounds, [0.0]])
    np.testing.assert_array_equal(groups[0].assign(sizes),
                                  groups[1].assign(sizes))
    for size in sizes[::10]:
        assert (port_s.get_group(size, groups[0].items())
                == jax_s.get_group(size, groups[1].items()))
    assert port_s.read_size_groups(GROUPS) == jax_s.read_size_groups(GROUPS)
