"""The window attention against its roofline while ROIs are classified:
the least time of the attention of the window's ROIs
(``bench_port/attention_bytes.py``, from the reference network's padded
windows: q, k, v read once and the output written once at the card's
memory rate, or the two products' FLOPs at the float32 peak, whichever is
longer) over the device time of the attention kernels in the trace: names
holding ``fmha`` (the memory-efficient SDPA kernel,
``fmha_cutlassF_f32_...``), ``attention`` or ``flash``, in any case.
Silent where their launches are not a whole multiple of the forward's
attentions (12 in Swin-T), and for a network without attention."""

from bench_port.attention_bytes import attention_roofline

KERNELS = ("fmha", "attention", "flash")


def read(ctx):
    return attention_roofline(ctx, KERNELS)
