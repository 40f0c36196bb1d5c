"""K1's evaluation form against its roofline: the least time its traffic
takes at the card's memory rate (each shipped ROI pixel read once, each
slot's output written once at its dtype, each slot's metadata read once;
counted from what the window fed, whatever kernel does the work) over the
device time of the kernels named ``resize_pad`` in the trace."""

from bench_port.flops import k1_eval_bytes, peaks

KERNEL = "resize_pad"


def read(ctx):
    t, d = ctx["tallies"], ctx["device"]
    k1_s = sum(s for name, (s, _) in ctx["trace"]["kernels"].items()
               if KERNEL in name)
    if d["platform"] != "gpu" or not k1_s:
        return None
    chans, target, _ = ctx["cfg"]["image_shape"]
    least = k1_eval_bytes(t["shipped_pixels"], t["rois"], target, chans,
                          t["dtype"]) / peaks(d["kind"])["hbm_bytes_per_s"]
    return 100.0 * least / k1_s
