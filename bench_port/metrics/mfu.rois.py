"""The model's share of the card's peak while ROIs are classified: forward
FLOPs of one ROI (the reference network on the configuration's shapes) times
the ROIs of the window, over the window's seconds, over the peak of the
precision computed (float32 with TF32 off: the non-tensor-core rate)."""

from bench_port.flops import forward_flops, peaks


def read(ctx):
    t = ctx["tallies"]
    if ctx["device"]["platform"] != "gpu" or not t["rois"]:
        return None
    peak = peaks(ctx["device"]["kind"])["flops_per_s"][t["dtype"]]
    flops = forward_flops(t["net"], ctx["cfg"]) * t["rois"]
    return 100.0 * flops / t["window_s"] / peak
