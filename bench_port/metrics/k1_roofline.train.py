"""K1's train form against its roofline: the least time its traffic takes
at the card's memory rate (each image of weight 1 stepped in the window:
its shipped pixels read once, its output written once at the training
dtype, its slot metadata, affine rows and brightness read once) over the
device time of the kernels named ``resize_pad`` in the trace."""

from bench_port.flops import k1_train_bytes, peaks

KERNEL = "resize_pad"


def read(ctx):
    t, d = ctx["tallies"], ctx["device"]
    k1_s = sum(s for name, (s, _) in ctx["trace"]["kernels"].items()
               if KERNEL in name)
    if d["platform"] != "gpu" or not k1_s:
        return None
    chans, target, _ = ctx["cfg"]["image_shape"]
    least = k1_train_bytes(t["shipped_pixels"], t["images"], target, chans,
                           t["dtype"]) / peaks(d["kind"])["hbm_bytes_per_s"]
    return 100.0 * least / k1_s
