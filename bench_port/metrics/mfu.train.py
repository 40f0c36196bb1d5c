"""The model's share of the card's peak while it trains: three times the
forward FLOPs of one image (forward, and the backward's two products) times
the images of weight 1 stepped in the window, over the window's seconds,
over the peak of the precision computed (bfloat16 autocast)."""

from bench_port.flops import forward_flops, peaks

PASSES = 3


def read(ctx):
    t = ctx["tallies"]
    if ctx["device"]["platform"] != "gpu" or not t["images"]:
        return None
    peak = peaks(ctx["device"]["kind"])["flops_per_s"][t["dtype"]]
    flops = PASSES * forward_flops(t["net"], ctx["cfg"]) * t["images"]
    return 100.0 * flops / t["window_s"] / peak
