"""Share of the dispatched slots that carry a ROI: the port's ``StageTimer``
counters ``engine.rois`` (real ROIs) over ``engine.slots`` (slots, padding
included; the model runs its full forward on both)."""


def read(ctx):
    stages = ctx["tallies"]["stages"]
    if not stages.get("engine.slots"):
        return None
    return 100.0 * stages.get("engine.rois", 0) / stages["engine.slots"]
