"""Host thread-milliseconds of decode, packing and slot metadata (with the
wire encoder, which runs inside the metadata stage) per 1,000 ROIs: the
port's ``StageTimer`` stages ``host.decode+pack`` and ``host.meta``, summed
over the threads that run them."""

STAGES = ("host.decode+pack", "host.meta")


def read(ctx):
    t = ctx["tallies"]
    stages = t["stages"]
    if not t["rois"] or not any(s in stages for s in STAGES):
        return None
    return 1e6 * sum(stages.get(s, 0.0) for s in STAGES) / t["rois"]
