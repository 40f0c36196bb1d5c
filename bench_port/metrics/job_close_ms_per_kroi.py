"""Milliseconds of each job's close per 1,000 ROIs: the port's
``StageTimer`` span ``prob.job_close``, from the last drained sample through
the straggler CSVs to the writer pool's join, on the calling thread."""

SPAN = "prob.job_close"


def read(ctx):
    t = ctx["tallies"]
    if not t["rois"] or SPAN not in t["stages"]:
        return None
    return 1e6 * t["stages"][SPAN] / t["rois"]
