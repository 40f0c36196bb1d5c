"""LayerNorm against its roofline while ROIs are classified: the least
bytes of every LayerNorm of the forward (``bench_port/norm_bytes.py``: each
normalised tensor read once, each result written once) times the window's
ROIs, at the card's memory rate, over the device time of ATen's LayerNorm
kernels in the trace: names holding ``layer_norm`` (the one-kernel
``vectorized_layer_norm_kernel``), ``layernorm`` or ``RowwiseMoments``
(the two-kernel form), in any case. Silent where their launches are not a
whole multiple of the forward's LayerNorms (22 in ConvNeXt-T)."""

from bench_port.norm_bytes import roofline_share

KERNELS = ("layer_norm", "layernorm", "RowwiseMoments")


def read(ctx):
    return roofline_share(ctx, "layer_norm", KERNELS)
