"""Milliseconds the engine's drain thread waits for the card's results (and
unpacks them) per 1,000 ROIs: the port's ``StageTimer`` stage
``device.drain``."""


def read(ctx):
    t = ctx["tallies"]
    if not t["rois"] or "device.drain" not in t["stages"]:
        return None
    return 1e6 * t["stages"]["device.drain"] / t["rois"]
