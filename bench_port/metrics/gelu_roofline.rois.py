"""GELU against its roofline while ROIs are classified: the least bytes of
every GELU of the forward (``bench_port/norm_bytes.py``: each input read
once, each result written once) times the window's ROIs, at the card's
memory rate, over the device time of the kernels whose names hold ``gelu``
in any case (ATen's ``GeluCUDAKernelImpl``). ATen runs a GELU over more
than 2**31 bytes (ConvNeXt-T's first stage, above 690 slots) as several
launches, so the launches are held only to at least the forward's GELUs
(18 in ConvNeXt-T) a dispatch, a dispatch counted by K1's launches; silent
below that."""

from bench_port.norm_bytes import roofline_share

KERNELS = ("gelu",)


def read(ctx):
    return roofline_share(ctx, "gelu", KERNELS, splits=True)
