"""Least work of the window attention of a reference network: the
yardstick of the attention kernels' share of their roofline.

:func:`forward_attention_work` runs one image through a reference network
over meta tensors and, for every product of a softmax's output with the
values (``attn @ v``: ``(G, N, N) x (G, N, d)`` over ``G`` windows times
heads), counts q, k and v read once and the output written once at their
dtype, ``4 G N d`` values, and the two products' ``4 G N N d`` FLOPs.
The bias and mask added to the scores are left out: they are read once a
launch, not once a ROI. The shapes are the reference's padded windows,
whatever kernel the program runs; the count is zero for a network without
attention.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .flops import peaks

SOFTMAX = (torch.ops.aten._softmax, torch.ops.aten.softmax)
PRODUCTS = (torch.ops.aten.bmm, torch.ops.aten.matmul)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"calls": 0, "bytes": 0, "flops": 0}
        self.after_softmax = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet in SOFTMAX:
            self.after_softmax = True
        elif packet in PRODUCTS and self.after_softmax:
            self.after_softmax = False
            v = args[1]
            g, n, d = v.shape[0], v.shape[-2], v.shape[-1]
            self.counts["calls"] += 1
            self.counts["bytes"] += 4 * g * n * d * v.element_size()
            self.counts["flops"] += 4 * g * n * n * d
        return out


def forward_attention_work(net, cfg: dict) -> dict:
    """``{"calls", "bytes", "flops"}`` of the attention of one
    ``cfg["image_shape"]`` image through ``net``: how many attentions the
    forward runs, and the least bytes and the FLOPs of them all."""
    params = {name: torch.empty(shape, device="meta",
                                dtype=torch.int64 if kind == "bn_count"
                                else torch.float32)
              for name, shape, kind, _ in net.param_specs(cfg)}
    x = torch.empty((1, *cfg["image_shape"]), device="meta")
    with _Counter() as counter:
        net.forward(params, x, cfg)
    return counter.counts


def attention_roofline(ctx: dict, names) -> float | None:
    """A traced window's share of the attention's roofline (a reader's
    ``ctx``), or None: the least time of the window's ROIs' attention (the
    greater of its bytes at the card's memory rate and its FLOPs at the
    float32 peak) over the device time of the kernels whose names hold one
    of ``names`` (in any case). Silent without a card, without such
    kernels, or where their launches are not a whole multiple of the
    forward's attentions (so that none ran in kernels of other names)."""
    t, d = ctx["tallies"], ctx["device"]
    if d["platform"] != "gpu" or not t["rois"]:
        return None
    wanted = tuple(w.lower() for w in names)
    hits = [v for name, v in ctx["trace"]["kernels"].items()
            if any(w in name.lower() for w in wanted)]
    seconds, launches = sum(s for s, _ in hits), sum(n for _, n in hits)
    work = forward_attention_work(t["net"], ctx["cfg"])
    if not seconds or not work["calls"] or launches % work["calls"]:
        return None
    peak = peaks(d["kind"])
    least = t["rois"] * max(work["bytes"] / peak["hbm_bytes_per_s"],
                            work["flops"] / peak["flops_per_s"]["float32"])
    return 100.0 * least / seconds
