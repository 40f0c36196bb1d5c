"""Size-group binning of a feature column: the ``size`` sub-command (a copy
of ``sykepic_tpu/compute/size_group.py``; behavioral contract of reference
``sykepic/compute/size_group.py``).

Contract: a ``name lower_bound`` groups file; each ROI's ``size_column``
value lands in the group with the largest ``lower_bound <= size`` (values
below every bound fall into the smallest group); ``value_column`` (or a
count of 1 for ``abundance``) accumulates per group. Output columns run
smallest group first, then ``total`` and optionally ``volume_ml``; the index
is the ISO sample timestamp.

The reference parses every CSV line in a Python loop
(``size_group.py:105-149``); here each feature CSV is read once with pandas
and binned in one ``np.searchsorted`` + ``np.bincount`` pass. pandas is
imported inside the functions that use it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ingest.ifcb import filter_out_quality_flagged_samples
from ..utils.timefmt import sample_to_datetime
from .classification import read_volume_ml
from .output import progress
from .units import pixels_to_um3


class SizeGroups:
    """Parsed groups file: names with ascending lower bounds."""

    def __init__(self, names_desc, bounds_desc):
        # stored descending (file convention), exposed both ways
        self.names_desc = list(names_desc)
        self.bounds_desc = list(bounds_desc)

    @classmethod
    def from_file(cls, path) -> "SizeGroups":
        entries = {}
        for line in Path(path).read_text().splitlines():
            parts = line.strip().split()
            if parts:
                entries[parts[0]] = float(parts[1])
        ordered = sorted(entries.items(), key=lambda kv: kv[1], reverse=True)
        return cls([n for n, _ in ordered], [b for _, b in ordered])

    @property
    def ascending_bounds(self) -> np.ndarray:
        return np.array(self.bounds_desc[::-1])

    @property
    def ascending_names(self) -> list:
        return self.names_desc[::-1]

    def assign(self, sizes: np.ndarray) -> np.ndarray:
        """Ascending group index per size (0 = smallest group; sizes below
        every bound also map to 0)."""
        idx = np.searchsorted(self.ascending_bounds, sizes, side="right") - 1
        return np.maximum(idx, 0)

    def items(self):
        return list(zip(self.names_desc, self.bounds_desc))


def bin_feature_csv(csv, groups: SizeGroups, size_column: str,
                    value_column: str, px_to_um3: bool = False):
    """One feature CSV -> (per-group sums ascending, volume_ml)."""
    import pandas as pd

    volume_ml = read_volume_ml(csv)
    df = pd.read_csv(csv, comment="#")
    if size_column not in df.columns:
        raise ValueError(f"Column '{size_column}' not found in header")
    sizes = df[size_column].to_numpy(dtype=float)
    if px_to_um3:
        sizes = pixels_to_um3(sizes)
    if value_column == "abundance":
        values = np.ones(len(df))
    elif value_column in df.columns:
        values = df[value_column].to_numpy(dtype=float)
    else:
        raise ValueError(f"Column '{value_column}' not found in header")
    n_groups = len(groups.names_desc)
    sums = np.bincount(groups.assign(sizes), weights=values, minlength=n_groups)
    return sums, volume_ml


def size_table(
    feats,
    groups: SizeGroups,
    size_column: str,
    value_column: str,
    verbose: bool = False,
    px_to_um3: bool = False,
    volume_info: bool = False,
) -> pd.DataFrame:
    """All samples binned into one frame, smallest group first + ``total``
    (+ ``volume_ml``), sample-name index sorted ascending."""
    import pandas as pd

    names = groups.ascending_names
    records = {}
    volumes = {}
    iterator = (progress(feats, f"Processing {len(feats)} samples")
                if verbose else feats)
    for csv in iterator:
        sample = Path(csv).with_suffix("").stem
        if sample.endswith("_biovol"):
            # the reference's split("_")[0] (size_group.py:84-85) truncates
            # at the FIRST underscore, dropping the instrument id; strip
            # only the suffix
            sample = sample[: -len("_biovol")]
        sums, volume_ml = bin_feature_csv(
            csv, groups, size_column, value_column, px_to_um3
        )
        records[sample] = sums
        volumes[sample] = volume_ml
    df = pd.DataFrame.from_dict(records, orient="index", columns=names)
    df.index.name = "sample"
    df["total"] = df.sum(axis=1)
    if volume_info:
        df["volume_ml"] = pd.Series(volumes)
    return df.sort_index()


def main(
    feats,
    groups_file,
    size_column,
    value_column,
    out_csv,
    append,
    verbose=False,
    px_to_um3=False,
    volume_info=False,
    sample_as_time=True,
):
    groups = SizeGroups.from_file(groups_file)
    df = size_table(
        feats, groups, size_column, value_column, verbose, px_to_um3, volume_info
    )
    if sample_as_time:
        df.index = df.index.map(lambda s: sample_to_datetime(s, isoformat=True))
        df.index.name = "time"
    from .output import write_frame

    write_frame(df, out_csv, append, na_rep=0.0)
    return df


def call(args):
    """CLI adapter (argument surface = reference ``size_group.py:10-37``)."""
    from .output import csv_tree, resolve_output

    all_feats = csv_tree(args.features)
    feats = (
        filter_out_quality_flagged_samples(all_feats, Path(args.exclusion_list))
        if args.exclusion_list
        else all_feats
    )
    resolve_output(args.out, args.append, args.force)
    return main(
        feats=feats,
        groups_file=args.groups,
        size_column=args.size_column,
        value_column=args.value_column if args.value_column else args.size_column,
        out_csv=args.out,
        append=args.append,
        verbose=not args.quiet,
        px_to_um3=args.pixels_to_um3,
        volume_info=args.volume,
        sample_as_time=True,
    )


# ------------------------------------------------------ single-value helpers
def read_size_groups(path):
    """``[(name, bound), ...]`` descending (kept for API parity)."""
    return SizeGroups.from_file(path).items()


def get_group(size, groups):
    """Group name for one size value (kept for API parity)."""
    for name, lower_bound in groups:
        if size >= lower_bound:
            return name
    return groups[-1][0]
