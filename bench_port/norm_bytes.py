"""Least bytes of the normalisation and activation passes that no FLOP
count sees: the yardstick of LayerNorm's and GELU's shares of their
rooflines.

:func:`forward_norm_bytes` runs one image through a reference network over
meta tensors and, for every ``aten.native_layer_norm`` and every
``aten.gelu`` it calls, counts the normalised (or activated) tensor read
once and its result written once, at their dtypes. LayerNorm's scale and
shift, and the row statistics it may keep, are not counted: they are read
once a launch, not once a ROI, or needed by no later operation. The count
follows the network's own calls, so it is zero for a network without them.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .flops import peaks

K1_KERNEL = "resize_pad"  # one launch a dispatch on the prob path
OPS = {torch.ops.aten.native_layer_norm: "layer_norm",
       torch.ops.aten.gelu: "gelu"}


def _bytes(t) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {name: {"calls": 0, "bytes": 0}
                       for name in OPS.values()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = OPS.get(func.overloadpacket)
        if name is not None:
            result = out[0] if isinstance(out, tuple) else out
            self.counts[name]["calls"] += 1
            self.counts[name]["bytes"] += _bytes(args[0]) + _bytes(result)
        return out


def forward_norm_bytes(net, cfg: dict) -> dict:
    """``{"layer_norm" | "gelu": {"calls", "bytes"}}`` of one
    ``cfg["image_shape"]`` image through ``net``: how many times the
    forward calls each, and the least bytes they move."""
    params = {name: torch.empty(shape, device="meta",
                                dtype=torch.int64 if kind == "bn_count"
                                else torch.float32)
              for name, shape, kind, _ in net.param_specs(cfg)}
    x = torch.empty((1, *cfg["image_shape"]), device="meta")
    with _Counter() as counter:
        net.forward(params, x, cfg)
    return counter.counts


def roofline_share(ctx: dict, op: str, names, splits: bool = False):
    """A traced window's share of ``op``'s roofline (a reader's ``ctx``), or
    None: ``op``'s least bytes for the window's ROIs at the card's memory
    rate, over the device time of the kernels whose names hold one of
    ``names`` (in any case).

    The launches of those kernels are held against the forward's calls of
    ``op``, so that calls run in kernels of other names, whose time this
    would leave out, silence the share. Without ``splits`` each call is
    one launch (or a fixed number), and the launches have to be a whole
    multiple of the calls a forward. With ``splits`` a call may take
    several launches (ATen's elementwise kernels split a tensor of more
    than 2**31 bytes into pieces it indexes in 32 bits, and how many
    depends on each dispatch's slots), and each dispatch has to launch at
    least its calls, a dispatch counted by K1's launches (one a dispatch
    on the ``prob`` path). None as well without a card or without such
    kernels."""
    t, d = ctx["tallies"], ctx["device"]
    if d["platform"] != "gpu" or not t["rois"]:
        return None
    kernels = ctx["trace"]["kernels"]

    def matched(wanted):
        wanted = tuple(w.lower() for w in wanted)
        hits = [v for name, v in kernels.items()
                if any(w in name.lower() for w in wanted)]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    seconds, launches = matched(names)
    forward = forward_norm_bytes(t["net"], ctx["cfg"])[op]
    if not seconds or not forward["calls"]:
        return None
    if splits:
        _, dispatches = matched((K1_KERNEL,))
        if not dispatches or launches < forward["calls"] * dispatches:
            return None
    elif launches % forward["calls"]:
        return None
    least = forward["bytes"] * t["rois"] / peaks(d["kind"])["hbm_bytes_per_s"]
    return 100.0 * least / seconds
