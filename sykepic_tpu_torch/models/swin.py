"""Swin Transformer T/S/B (Liu et al., arXiv:2103.14030) + the MLP head,
in torchvision's topology and key layout: ``features`` = [patch embedding,
stage 1, merge, stage 2, merge, stage 3, merge, stage 4], then ``norm``,
the mean over H and W, and ``head``. The JAX package has no Swin; the
upstream syke-pic runs torchvision's ``swin_t`` as ``base =
Sequential(children[:-1])``, which keeps ``features`` (``base.0``) and the
final ``norm`` (``base.1``).

- Patch embedding (``features.0``): 4x4/4 conv (bias) -> NHWC -> LayerNorm.
- :class:`SwinBlock`: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``
  (Linear 4x -> exact GELU -> Linear), each branch under row-mode
  stochastic depth; blocks alternate plain (shift 0) and shifted (shift 3)
  windows of 7x7.
- :class:`ShiftedWindowAttention` is torchvision's
  ``shifted_window_attention``: the normed tokens padded at the bottom and
  right to multiples of the window, the shift set to 0 along an axis whose
  padded size the window covers, a cyclic roll by minus the shift, ``qkv``
  on the padded windows, each head's learned relative-position bias
  (``relative_position_bias_table`` gathered by ``relative_position_index``)
  plus, only where something is shifted, -100 between tokens of different
  regions, the softmax, ``proj``, then the windows, the roll and the
  padding undone. Padded tokens stay keys every query attends to.
- :class:`PatchMerging`: odd H or W padded by one, the 2x2 neighbours
  concatenated (``x[0::2, 0::2]``, ``x[1::2, 0::2]``, ``x[0::2, 1::2]``,
  ``x[1::2, 1::2]``), LayerNorm, then ``reduction`` (no bias) to 2x the
  width.

The activations are NHWC throughout, and the eval model runs channels_last,
so the patch embedding's permute is a free view. Attention is one
``F.scaled_dot_product_attention`` call a block, its bias and region mask
one additive float mask broadcast over the images: the windows of an image
and their heads share SDPA's head axis, the window's position its sequence
axis. On the card the memory-efficient backend runs it, one fused kernel a
block (float32, with an additive mask).

In an eval forward on the card (:func:`~.layers.eval_kernel_runs` of the
NCHW view) every LayerNorm of at most
:data:`~sykepic_tpu_torch.ops.layernorm.MAX_CHANNELS` channels is the
hand-written kernel of :mod:`sykepic_tpu_torch.ops.layernorm` (29 launches
a Swin-T forward), the patch convolution's bias added inside it
(``pre_bias``); elsewhere ATen's LayerNorm runs. The modules, parameters
and state-dict keys are the same on both paths.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import layernorm
from .convnext import Permute
from .layers import conv_no_bias, eval_kernel_runs
from .resnet import Backbone, Head, StochasticDepth

# name -> (embedding width, blocks per stage, heads per stage, stochastic
# depth prob)
SWIN_CFGS: dict[str, tuple] = {
    "swin_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 0.2),
    "swin_s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 0.3),
    "swin_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 0.5),
}

WINDOW = 7
PATCH = 4
MLP_RATIO = 4
LN_EPS = 1e-5
REGION_MASK = -100.0
MASK_ALIGN = 8  # SDPA's memory-efficient kernel reads its mask rows aligned


def relative_position_index(window: int) -> torch.Tensor:
    """``(window**4,)`` int64: for each query and key of a window, the row
    of the bias table that holds their offset (torchvision's buffer)."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing="ij")
    coords = torch.stack((ys.flatten(), xs.flatten()))
    rel = (coords[:, :, None] - coords[:, None, :]) + (window - 1)
    return (rel[0] * (2 * window - 1) + rel[1]).flatten()


def _regions(n: int, window: int, shift: int, device) -> torch.Tensor:
    """The region of each row (or column) of a padded, rolled axis of
    ``n``: 0 before ``n - window``, 1 before ``n - shift``, 2 after; all
    one region where the axis is not shifted. Made on ``device``: a copy
    from the host would wait for the device's queue."""
    r = torch.arange(n, device=device)
    if not shift:
        return torch.zeros_like(r)
    return (r >= n - window).long() + (r >= n - shift).long()


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _norm(norm: nn.LayerNorm, x: torch.Tensor,
          pre_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``norm`` of NHWC ``x`` (plus ``pre_bias``): the eval kernel where
    the rule holds and it takes the width, else ATen's LayerNorm."""
    c = x.shape[-1]
    if (c <= layernorm.MAX_CHANNELS and c % 4 == 0
            and eval_kernel_runs(x.permute(0, 3, 1, 2), norm)):
        return layernorm.layernorm(x, norm.weight, norm.bias, norm.eps,
                                   pre_bias=pre_bias)
    if pre_bias is not None:
        x = x + pre_bias
    return norm(x)


class PatchEmbed(nn.Sequential):
    """The 4x4/4 convolution, the permute to NHWC and the LayerNorm; on
    the eval kernel's path the LayerNorm adds the convolution's bias."""

    def forward(self, x):
        conv, _, norm = self
        if type(conv) is not nn.Conv2d or not eval_kernel_runs(x, self):
            return super().forward(x)
        return _norm(norm, conv_no_bias(conv, x), pre_bias=conv.bias)


class ShiftedWindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, shift: int, heads: int):
        super().__init__()
        self.window, self.shift, self.num_heads = window, shift, heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window))

    def shifts(self, pad_h: int, pad_w: int) -> tuple[int, int]:
        """The shift along each axis of a padded map: none where the window
        covers the axis."""
        w = self.window
        return (0 if w >= pad_h else self.shift,
                0 if w >= pad_w else self.shift)

    def attn_mask(self, pad_h: int, pad_w: int, ref: torch.Tensor
                  ) -> torch.Tensor:
        """``(1, windows * heads, N, N)``: each head's relative-position
        bias, plus -100 between tokens of different regions of a shifted
        window, on ``ref``'s device and dtype; rows padded to
        :data:`MASK_ALIGN` in memory, so SDPA reads the mask in place."""
        w, heads = self.window, self.num_heads
        n = w * w
        bias = self.relative_position_bias_table[
            self.relative_position_index].view(n, n, heads).permute(2, 0, 1)
        sh, sw = self.shifts(pad_h, pad_w)
        rows = (_regions(pad_h, w, sh, ref.device)[:, None] * 3
                + _regions(pad_w, w, sw, ref.device))
        ids = rows.view(pad_h // w, w, pad_w // w, w).permute(
            0, 2, 1, 3).reshape(-1, n)
        region = (ids[:, None, :] != ids[:, :, None]) * REGION_MASK
        mask = ref.new_empty(ids.shape[0], heads, n,
                             _ceil(n, MASK_ALIGN) * MASK_ALIGN)[..., :n]
        mask.copy_(bias[None] + region[:, None].to(ref.dtype))
        return mask.flatten(0, 1)[None]

    def forward(self, x):
        """NHWC ``x`` (the normed tokens) -> NHWC."""
        b, h, w_, c = x.shape
        w, heads = self.window, self.num_heads
        x = F.pad(x, (0, 0, 0, -w_ % w, 0, -h % w))
        pad_h, pad_w = x.shape[1:3]
        sh, sw = self.shifts(pad_h, pad_w)
        if sh or sw:
            x = torch.roll(x, (-sh, -sw), (1, 2))
        nh, nw = pad_h // w, pad_w // w
        # (B, N, windows, C): the windows and their heads merge into SDPA's
        # head axis, which the mask broadcasts along the images
        x = x.view(b, nh, w, nw, w, c).permute(0, 2, 4, 1, 3, 5).reshape(
            b, w * w, nh * nw, c)
        q, k, v = (F.linear(x, wt, bt).view(b, w * w, -1, c // heads)
                   .transpose(1, 2)
                   for wt, bt in zip(self.qkv.weight.chunk(3),
                                     self.qkv.bias.chunk(3)))
        mask = self.attn_mask(pad_h, pad_w, q)
        # the scale is SDPA's default, head dim ** -0.5
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        y = self.proj(y.transpose(1, 2).reshape(b, w * w, nh * nw, c))
        y = y.view(b, w, w, nh, nw, c).permute(0, 3, 1, 4, 2, 5).reshape(
            b, pad_h, pad_w, c)
        if sh or sw:
            y = torch.roll(y, (sh, sw), (1, 2))
        return y[:, :h, :w_].contiguous()


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 sd_prob: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ShiftedWindowAttention(dim, window, shift, heads)
        self.stochastic_depth = StochasticDepth(sd_prob)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.Sequential(
            nn.Linear(dim, MLP_RATIO * dim), nn.GELU(), nn.Dropout(0.0),
            nn.Linear(MLP_RATIO * dim, dim), nn.Dropout(0.0))

    def forward(self, x):
        x = x + self.stochastic_depth(self.attn(_norm(self.norm1, x)))
        return x + self.stochastic_depth(self.mlp(_norm(self.norm2, x)))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)

    def forward(self, x):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(_norm(self.norm, x))


class SwinTransformer(Backbone):
    def __init__(self, embed_dim: int, depths: Sequence[int],
                 heads: Sequence[int], sd_prob: float, num_classes: int,
                 head: Sequence[int] = (256, 128), dropout: Sequence = ()):
        super().__init__()
        layers = [PatchEmbed(nn.Conv2d(3, embed_dim, PATCH, stride=PATCH),
                             Permute((0, 2, 3, 1)),
                             nn.LayerNorm(embed_dim, eps=LN_EPS))]
        total, block_id = sum(depths), 0
        for i, (n, n_heads) in enumerate(zip(depths, heads)):
            dim = embed_dim * 2 ** i
            stage = []
            for j in range(n):
                stage.append(SwinBlock(
                    dim, n_heads, WINDOW, 0 if j % 2 == 0 else WINDOW // 2,
                    sd_prob * block_id / max(total - 1, 1)))
                block_id += 1
            layers.append(nn.Sequential(*stage))
            if i < len(depths) - 1:
                layers.append(PatchMerging(dim))
        self.features = nn.Sequential(*layers)
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.num_features, eps=LN_EPS)
        self.head = Head(self.num_features, head, num_classes, dropout)

    def eval_memory_format(self, dtype) -> torch.memory_format:
        """channels_last whatever the dtype: the blocks compute in NHWC,
        which the patch embedding's permute gives as a free view only from
        a channels_last convolution."""
        return torch.channels_last

    def dispatch_counts(self, height: int, width: int) -> dict[str, int]:
        """Over every block of one ``height x width`` image: the windows
        attended (``swin.windows``), their query tokens, padding included
        (``swin.tokens``), and how many of those are padding
        (``swin.pad_tokens``)."""
        h, w = height // PATCH, width // PATCH
        counts = dict.fromkeys(("swin.windows", "swin.tokens",
                                "swin.pad_tokens"), 0)
        for layer in self.features[1:]:
            if isinstance(layer, PatchMerging):
                h, w = _ceil(h, 2), _ceil(w, 2)
                continue
            for block in layer:
                win = block.attn.window
                windows = _ceil(h, win) * _ceil(w, win)
                counts["swin.windows"] += windows
                counts["swin.tokens"] += windows * win * win
                counts["swin.pad_tokens"] += windows * win * win - h * w
        return counts

    def embed(self, x):
        return _norm(self.norm, self.features(x)).mean(dim=(1, 2))


def _swin(name: str, **kw) -> SwinTransformer:
    embed_dim, depths, heads, sd = SWIN_CFGS[name]
    return SwinTransformer(embed_dim, depths, heads, sd, **kw)


def swin_t(**kw) -> SwinTransformer:
    return _swin("swin_t", **kw)


def swin_s(**kw) -> SwinTransformer:
    return _swin("swin_s", **kw)


def swin_b(**kw) -> SwinTransformer:
    return _swin("swin_b", **kw)
