"""Plain Swin-T (Liu et al., "Swin Transformer: Hierarchical Vision
Transformer using Shifted Windows", arXiv:2103.14030; torchvision's
``swin_t`` layout) with the stacked-linear head of the configuration.

Patch embedding: conv 4x4/4 (96, bias) -> NHWC -> LayerNorm. Four stages of
(2, 2, 6, 2) blocks at widths (96, 192, 384, 768) with (3, 6, 12, 24) heads
of 32 channels, stages 2-4 each led by a patch merging of the stage before
(odd H or W padded by one at the end, the 2x2 neighbours ``x[0::2, 0::2]``,
``x[1::2, 0::2]``, ``x[0::2, 1::2]``, ``x[1::2, 1::2]`` concatenated,
LayerNorm, Linear without bias to twice the width). A block: ``x +
attention(LayerNorm(x))``, then ``x + Linear(GELU(Linear(LayerNorm(x))))``
at 4x the width (the exact erf GELU). The attention, in windows of 7x7:
the normed tokens padded at the bottom and right to multiples of 7; the
shift 3 on every second block, set to 0 along an axis whose padded size is
at most 7; a cyclic roll by minus the shift; q, k, v from ``qkv``; ``q *
32 ** -0.5`` times k transposed; plus each head's bias gathered from its
table of 13 x 13 offsets; plus, only where something is shifted, -100
between tokens of different regions; softmax; times v; ``proj``; the
windows, the roll and the padding undone. Padded tokens are keys like any
other. Then a final LayerNorm, the mean over H and W, and ``head`` linears
(no activation between them). LayerNorm eps 1e-5; no stochastic depth or
dropout (evaluation).

Departures from the published network:

- syke-pic's stacked-linear ``head`` replaces torchvision's ``head``;
- the final ``norm`` is kept, as the reference syke-pic keeps it (its
  ``children[:-1]`` drops only torchvision's ``head``).

``cfg["swin"]`` may set ``embed_dim``, ``depths``, ``heads`` and ``window``
(smaller networks for the CPU tests); the published sizes are the defaults.
The relative position index and the region mask are computed here as
torchvision computes them.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..layers import conv_spec, head, head_spec

EMBED_DIM = 96
DEPTHS = (2, 2, 6, 2)
HEADS = (3, 6, 12, 24)
WINDOW = 7
MLP_RATIO = 4
LN_EPS = 1e-5


def arch(cfg) -> tuple:
    """``(embed_dim, depths, heads, window)`` of ``cfg``."""
    s = cfg.get("swin", {})
    return (s.get("embed_dim", EMBED_DIM), tuple(s.get("depths", DEPTHS)),
            tuple(s.get("heads", HEADS)), s.get("window", WINDOW))


def _ln_spec(name: str, c: int) -> list:
    # LayerNorm's scale and shift drawn as BatchNorm's are (1 + 0.1 n and
    # 0.05 n); LayerNorm keeps no running statistics
    return [(f"{name}.weight", (c,), "bn_weight", None),
            (f"{name}.bias", (c,), "bn_bias", None)]


def _linear_spec(name: str, cout: int, cin: int, bias: bool = True) -> list:
    out = [(f"{name}.weight", (cout, cin), "linear", cin)]
    if bias:
        out.append((f"{name}.bias", (cout,), "linear_bias", None))
    return out


def _widths(cfg) -> list:
    embed_dim, depths, _, _ = arch(cfg)
    return [embed_dim * 2 ** (len(depths) - 1), *cfg["head"],
            cfg["num_classes"]]


def param_specs(cfg) -> list:
    embed_dim, depths, heads, window = arch(cfg)
    specs = conv_spec("features.0.0", embed_dim, cfg["image_shape"][0], 4,
                      bias=True)
    specs += _ln_spec("features.0.2", embed_dim)
    for i, (depth, n_heads) in enumerate(zip(depths, heads)):
        dim = embed_dim * 2 ** i
        for j in range(depth):
            b = f"features.{2 * i + 1}.{j}"
            specs += _ln_spec(f"{b}.norm1", dim)
            specs += _linear_spec(f"{b}.attn.qkv", 3 * dim, dim)
            specs += _linear_spec(f"{b}.attn.proj", dim, dim)
            # order 1 (a normal of variance 1 / fan-in 1), as a trained
            # table is; torchvision's init of std 0.02 would leave the
            # attention near uniform
            specs.append((f"{b}.attn.relative_position_bias_table",
                          ((2 * window - 1) ** 2, n_heads), "linear", 1))
            specs += _ln_spec(f"{b}.norm2", dim)
            specs += _linear_spec(f"{b}.mlp.0", MLP_RATIO * dim, dim)
            specs += _linear_spec(f"{b}.mlp.3", dim, MLP_RATIO * dim)
        if i < len(depths) - 1:
            merge = f"features.{2 * i + 2}"
            specs += _ln_spec(f"{merge}.norm", 4 * dim)
            specs += _linear_spec(f"{merge}.reduction", 2 * dim, 4 * dim,
                                  bias=False)
    specs += _ln_spec("norm", _widths(cfg)[0])
    return specs + head_spec(_widths(cfg))


def last_head_weight(cfg) -> str:
    return f"head.{len(_widths(cfg)) - 2}.weight"


def relative_position_index(window: int):
    """torchvision's ``relative_position_index``: ``(window**4,)``."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).flatten()


def window_mask(h: int, w: int, pad_h: int, pad_w: int, window: int,
                shift_h: int, shift_w: int, device):
    """The region mask of torchvision's shifted windows over the rolled
    ``pad_h x pad_w`` map of an ``h x w`` one: ``(windows, N, N)``, -100
    between tokens of different regions, else 0; None where nothing is
    shifted."""
    if not (shift_h or shift_w):
        return None
    ids = torch.zeros((pad_h, pad_w), device=device)
    h_slices = ((0, -window), (-window, -shift_h), (-shift_h, None))
    w_slices = ((0, -window), (-window, -shift_w), (-shift_w, None))
    count = 0
    for hs in h_slices:
        for ws in w_slices:
            ids[hs[0]:hs[1], ws[0]:ws[1]] = count
            count += 1
    ids = ids.view(pad_h // window, window, pad_w // window, window)
    ids = ids.permute(0, 2, 1, 3).reshape(-1, window * window)
    diff = ids.unsqueeze(1) - ids.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


def layer_norm(p: dict, name: str, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def attention(p: dict, name: str, x, heads: int, window: int, shift: int):
    """Shifted-window attention on NHWC ``x`` (the normed tokens)."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, (window - w % window) % window,
                  0, (window - h % window) % window))
    pad_h, pad_w = x.shape[1:3]
    shift_h = 0 if window >= pad_h else shift
    shift_w = 0 if window >= pad_w else shift
    if shift_h or shift_w:
        x = torch.roll(x, shifts=(-shift_h, -shift_w), dims=(1, 2))
    n_windows = (pad_h // window) * (pad_w // window)
    n = window * window
    x = x.view(b, pad_h // window, window, pad_w // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b * n_windows, n, c)
    qkv = F.linear(x, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"])
    qkv = qkv.reshape(b * n_windows, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    attn = (q * (c // heads) ** -0.5).matmul(k.transpose(-2, -1))
    table = p[f"{name}.relative_position_bias_table"]
    index = relative_position_index(window).to(table.device)
    bias = table[index].view(n, n, heads).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    mask = window_mask(h, w, pad_h, pad_w, window, shift_h, shift_w,
                       x.device)
    if mask is not None:
        attn = attn.view(b, n_windows, heads, n, n) + mask[None, :, None]
        attn = attn.view(b * n_windows, heads, n, n)
    attn = F.softmax(attn, dim=-1)
    x = attn.matmul(v).transpose(1, 2).reshape(b * n_windows, n, c)
    x = F.linear(x, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"])
    x = x.view(b, pad_h // window, pad_w // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, pad_h, pad_w, c)
    if shift_h or shift_w:
        x = torch.roll(x, shifts=(shift_h, shift_w), dims=(1, 2))
    return x[:, :h, :w, :]


def block(p: dict, name: str, x, heads: int, window: int, shift: int):
    x = x + attention(p, f"{name}.attn", layer_norm(p, f"{name}.norm1", x),
                      heads, window, shift)
    y = layer_norm(p, f"{name}.norm2", x)
    y = F.gelu(F.linear(y, p[f"{name}.mlp.0.weight"], p[f"{name}.mlp.0.bias"]))
    return x + F.linear(y, p[f"{name}.mlp.3.weight"], p[f"{name}.mlp.3.bias"])


def patch_merging(p: dict, name: str, x):
    h, w = x.shape[1:3]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], -1)
    return F.linear(layer_norm(p, f"{name}.norm", x),
                    p[f"{name}.reduction.weight"])


def forward(p: dict, x, cfg):
    """NCHW float32 images -> logits."""
    _, depths, heads, window = arch(cfg)
    x = F.conv2d(x, p["features.0.0.weight"], p["features.0.0.bias"],
                 stride=4)
    x = layer_norm(p, "features.0.2", x.permute(0, 2, 3, 1))
    for i, (depth, n_heads) in enumerate(zip(depths, heads)):
        for j in range(depth):
            x = block(p, f"features.{2 * i + 1}.{j}", x, n_heads, window,
                      0 if j % 2 == 0 else window // 2)
        if i < len(depths) - 1:
            x = patch_merging(p, f"features.{2 * i + 2}", x)
    x = layer_norm(p, "norm", x)
    return head(p, x.mean(dim=(1, 2)), len(_widths(cfg)) - 1)
