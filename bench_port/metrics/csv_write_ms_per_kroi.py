"""Writer thread-milliseconds of the ``.prob.csv`` files per 1,000 ROIs:
the port's ``StageTimer`` span ``prob.csv_write``, once a sample, summed
over the writer threads."""

SPAN = "prob.csv_write"


def read(ctx):
    t = ctx["tallies"]
    if not t["rois"] or SPAN not in t["stages"]:
        return None
    return 1e6 * t["stages"][SPAN] / t["rois"]
