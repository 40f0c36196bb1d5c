"""Plain layers shared by the reference networks: functional PyTorch over a
``{name: tensor}`` parameter dict, float32, NCHW, nothing fused.

Each network module (``nets/<network>.py``) gives ``param_specs(cfg)``, a
list of ``(name, shape, kind, fan_in)`` in torchvision's key layout (the one
a ``best_state.pth`` carries), ``forward(params, x, cfg)`` and
``last_head_weight(cfg)``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

BN_EPS = 1e-5


class tf32:
    """Context manager that sets TF32 in cuDNN and cuBLAS, restoring the
    previous settings on exit. The reference runs with it off: float32
    convolutions and matrix products on the card otherwise round their
    inputs to TF32's 10-bit mantissa."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.on
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def conv_spec(name: str, cout: int, cin: int, k: int, groups: int = 1,
              bias: bool = False) -> list:
    out = [(f"{name}.weight", (cout, cin // groups, k, k), "conv",
            cin // groups * k * k)]
    if bias:
        out.append((f"{name}.bias", (cout,), "conv_bias", None))
    return out


def bn_spec(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "bn_weight", None),
            (f"{name}.bias", (c,), "bn_bias", None),
            (f"{name}.running_mean", (c,), "bn_mean", None),
            (f"{name}.running_var", (c,), "bn_var", None),
            (f"{name}.num_batches_tracked", (), "bn_count", None)]


def head_spec(widths) -> list:
    """``head.K`` linear layers over ``widths`` (in, hidden..., classes)."""
    out = []
    for k in range(len(widths) - 1):
        out += [(f"head.{k}.weight", (widths[k + 1], widths[k]), "linear",
                 widths[k]),
                (f"head.{k}.bias", (widths[k + 1],), "linear_bias", None)]
    return out


def rounded(t, dtype):
    """``t`` rounded to a float8 ``dtype`` with one scale for the tensor (its
    largest magnitude to the type's largest), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


def fake_fp8(t):
    """``t`` in float8 e4m3 (the forward's operands); the gradient passes
    straight through."""
    return t + (rounded(t.detach(), torch.float8_e4m3fn) - t).detach()


class _Fp8Grad(torch.autograd.Function):
    """The identity forward; backward rounds the incoming gradient to
    float8 e5m2, as float8 training feeds it to a layer's backward
    products."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, torch.float8_e5m2)


def _in(p: dict, t):
    """An operand of a convolution or product: as it is, or in float8 when
    ``p["quant"]`` is ``"fp8"`` (the control one precision below
    bfloat16)."""
    return fake_fp8(t) if p.get("quant") == "fp8" else t


def _out(p: dict, y):
    """A convolution's or product's result: its gradient in float8 e5m2
    when ``p["quant"]`` is ``"fp8"``, so that the backward products take
    float8 operands too."""
    return _Fp8Grad.apply(y) if p.get("quant") == "fp8" else y


def conv(p: dict, name: str, x, stride: int = 1, groups: int = 1):
    w = p[f"{name}.weight"]
    return _out(p, F.conv2d(_in(p, x), _in(p, w), p.get(f"{name}.bias"),
                            stride=stride, padding=w.shape[-1] // 2,
                            groups=groups))


def bn(p: dict, name: str, x, eps: float = BN_EPS):
    """BatchNorm by ``p["bn"]``: ``"eval"`` (the default) normalises with
    the running statistics; ``"train"`` with the batch's (the biased
    variance), leaving the running ones; ``"calibrate"`` with the batch's,
    writing them into the running ones (momentum 1)."""
    mode = p.get("bn", "eval")
    if mode == "train":
        return F.batch_norm(x, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], training=True, eps=eps)
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], training=mode == "calibrate",
                        momentum=1.0, eps=eps)


def head(p: dict, x, n_layers: int):
    """Stacked linear layers, no activation between them."""
    for k in range(n_layers):
        x = _out(p, F.linear(_in(p, x), _in(p, p[f"head.{k}.weight"]),
                             p[f"head.{k}.bias"]))
    return x
