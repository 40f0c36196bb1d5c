"""Milliseconds the engine's dispatch thread waits for the host's next
prepared batch per 1,000 ROIs: the port's ``StageTimer`` span
``engine.wait_input`` (at a job's head it covers the whole fill)."""

SPAN = "engine.wait_input"


def read(ctx):
    t = ctx["tallies"]
    if not t["rois"] or SPAN not in t["stages"]:
        return None
    return 1e6 * t["stages"][SPAN] / t["rois"]
