"""Meshes, collectives and tensor-parallel layers over ``torch.distributed``
(the port of ``sykepic_tpu/parallel/__init__.py``).

The JAX package runs one program over a mesh of devices and lets GSPMD
insert the collectives. Here one process runs per card (NCCL for ``cuda``,
gloo for ``cpu``; :mod:`.launch` starts or joins the group), a mesh is a
``DeviceMesh`` with dims named as JAX names its axes, and the collectives
are written out where the program needs them:

- :func:`data_mesh` -- 1-D ``("data",)`` mesh over every rank of the
  group; batches split over it, parameters replicate (the trainer and the
  inference engine).
- :func:`data_model_mesh` -- 2-D ``("data", "model")`` mesh for
  tensor-parallel sharding of wide kernels; rank ``d * model_parallel + m``
  sits at ``(d, m)``, as JAX reshapes its device list.
- :func:`shard_wide_kernels` -- tensor-parallel parameter placement by
  JAX's rule (:func:`wide_kernel_placement`); each sharded layer becomes a
  :class:`ColumnParallel` that holds its slice of the output channels and
  all-gathers them after computing them from the full input.
- :func:`shard_batch` / :func:`replicate` -- a rank's rows of a batch, and
  a tree made equal to the mesh's first rank's copy.

A batch of ``T`` rows splits as ``P("data")`` splits it: data rank ``d``
takes the contiguous rows ``[d c, (d + 1) c)`` with ``c = ceil(T / n)``,
clipped to ``T``, so a total the axis does not divide is fine and a rank
may hold no row (:func:`shard_rows`).
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
from torch import nn
from torch.autograd import Function
from torch.nn import functional as F

from .launch import (  # noqa: F401  (the launch helpers' public names)
    barrier,
    destroy_process_group,
    init_process_group,
    is_initialized,
    launched_by_torchrun,
    rank,
    spawn,
)

# The JAX package's patterns (``sykepic_tpu/parallel/__init__.py:37-38``),
# read against the Flax path of each parameter
# (:func:`~sykepic_tpu_torch.models.checkpoint.flax_paths`): the MLP head
# plus the widest final stage of each backbone family (ResNet layer4,
# EfficientNet layer7/head_conv). The backbone patterns anchor on the
# block-structured "layerN_<block index>" names, so VGG's flat
# "layer4_convJ" modules do NOT match.
WIDE_MODULE_PATTERNS = (r"head", r"layer4_\d+$", r"layer7_\d+$",
                        r"head_conv$")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start one with sykepic_tpu_torch.parallel."
            "init_process_group (or run under torchrun)")


def data_mesh():
    """1-D data-parallel mesh over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    return init_device_mesh(_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def data_model_mesh(model_parallel: int = 2):
    """2-D (data, model) mesh; ``model_parallel`` must divide the world
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}")
    return init_device_mesh(_device_type(), (n // model_parallel,
                                             model_parallel),
                            mesh_dim_names=("data", "model"))


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` of ``mesh``; 1 without the axis or the mesh."""
    if axis not in _names(mesh):
        return 1
    return mesh.size(_names(mesh).index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without it)."""
    if axis not in _names(mesh):
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``, or None."""
    if axis not in _names(mesh):
        return None
    return mesh.get_group(axis)


def data_axis_size(mesh) -> int:
    """Size of the batch-sharding axis (``data``), 1 if the mesh has none."""
    return axis_size(mesh, "data")


def has_model_axis(mesh) -> bool:
    return axis_size(mesh, "model") > 1


def shard_rows(total: int, n_shards: int, index: int) -> tuple[int, int]:
    """``[lo, hi)``: shard ``index`` of ``total`` rows split in ``n_shards``
    contiguous shards of ``ceil(total / n_shards)`` (the last ones shorter
    or empty)."""
    c = -(-total // max(n_shards, 1))
    lo = min(index * c, total)
    return lo, min(lo + c, total)


def shard_batch(mesh, *tensors):
    """This rank's rows of each tensor's leading axis (``P("data")``)."""
    n, d = data_axis_size(mesh), axis_index(mesh, "data")
    out = []
    for t in tensors:
        lo, hi = shard_rows(t.shape[0], n, d)
        out.append(t[lo:hi])
    return out[0] if len(out) == 1 else tuple(out)


def replicate(mesh, tree):
    """Broadcast every tensor of ``tree`` (a tensor, or dicts, lists and
    tuples of them) in place from the mesh's first rank, so that every
    rank holds its copy; returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])
    if isinstance(tree, torch.Tensor):
        dist.broadcast(tree, src)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate(mesh, v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(mesh, v)
    return tree


# ------------------------------------------------------------ collectives
class _AllReduceSum(Function):
    """Sum over ``group``; the gradient is summed over it too (each rank's
    loss reads the total, so the total's gradient is every rank's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(Function):
    """The identity, whose gradient is summed over ``group``: the input of
    a column-parallel layer, where each rank's slice of the output
    contributes its share of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherDim(Function):
    """All-gather along ``dim`` over ``group``. The backward takes this
    rank's slice of the gradient: every rank of the group holds the same
    downstream gradient, so summing it over the group (as
    ``torch.distributed.nn.functional.all_gather`` does) would multiply it
    by the group's size."""

    @staticmethod
    def forward(ctx, x, dim, group, index, n):
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        channels_last = (x.dim() == 4
                         and x.is_contiguous(memory_format=torch.channels_last)
                         and not x.is_contiguous())
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        y = torch.cat(parts, dim=dim)
        return y.contiguous(memory_format=torch.channels_last) \
            if channels_last else y

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                None, None, None, None)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (see :class:`_AllReduceSum`)."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, total: int, group, n: int) -> torch.Tensor:
    """The ``total`` rows that the ``n`` ranks of ``group`` hold as
    :func:`shard_rows` shards (``x`` this rank's), in order, on every rank:
    each shard is padded to ``ceil(total / n)`` rows for the all-gather."""
    c = -(-total // max(n, 1))
    pad = torch.zeros((c - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    x = torch.cat([x, pad]).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)[:total]


# ------------------------------------------------------- tensor parallel
def wide_kernel_placement(model, n_shards: int, min_width: int = 64,
                          module_patterns=WIDE_MODULE_PATTERNS) -> dict:
    """``{torch parameter name: sharded?}`` by the JAX package's rule
    (``sykepic_tpu/parallel/__init__.py:82-121``) read on each parameter's
    Flax path and Flax shape: a ``kernel`` (a convolution's or Linear's
    weight, rank >= 2) whose top module matches one of
    ``module_patterns`` (``re.match``) and whose output-feature dimension
    (Flax's last, torch's first) is at least ``min_width`` and divisible by
    ``n_shards``. Every other leaf (biases, norm parameters, ConvNeXt's
    ``layer_scale``, which Flax keeps 1-D) stays replicated."""
    from ..models import checkpoint

    paths = checkpoint.flax_paths(model.state_dict(),
                                  getattr(model, "network", None))
    compiled = tuple(re.compile(p) for p in module_patterns)
    out = {}
    for name, p in model.named_parameters():
        path = paths[name]  # ("params", top module, ..., leaf)
        wide = (n_shards > 1 and path[-1] == "kernel" and p.dim() >= 2
                and p.shape[0] >= min_width and p.shape[0] % n_shards == 0)
        out[name] = bool(wide and any(c.match(str(path[1]))
                                      for c in compiled))
    return out


class ColumnParallel(nn.Module):
    """A convolution or Linear whose output channels are split over a
    ``model`` group: this rank holds rows ``[lo, lo + per)`` of the weight
    (``weight``; the bias, 1-D, stays whole and replicated), computes those
    channels from the full input and all-gathers them, so the layers after
    it are unchanged. The input passes :class:`_CopyToGroup`, so its
    gradient is the sum of every slice's share.

    A grouped convolution's slice reads only its own groups' input
    channels: the slice is cut into runs of whole groups (one grouped
    convolution each) and at most two partial groups (one plain
    convolution each)."""

    def __init__(self, inner: nn.Module, group, index: int, n: int):
        super().__init__()
        if not isinstance(inner, (nn.Conv2d, nn.Linear)):
            raise TypeError(f"cannot shard a {type(inner).__name__}")
        out = inner.weight.shape[0]
        self.per = out // n
        self.lo = index * self.per
        self.index, self.n, self.group = index, n, group
        self.weight = nn.Parameter(
            inner.weight.detach()[self.lo:self.lo + self.per].clone())
        self.bias = inner.bias
        self.conv = isinstance(inner, nn.Conv2d)
        if self.conv:
            if inner.padding_mode != "zeros":
                raise ValueError("only zero-padded convolutions shard")
            self.stride, self.padding = inner.stride, inner.padding
            self.dilation = inner.dilation
            self.segments = self._segments(inner.groups, inner.in_channels,
                                           out)

    def _segments(self, groups: int, cin: int, cout: int) -> list:
        """``(first group, end group, first local row, end local row)``
        runs covering this rank's rows."""
        ipg, opg = cin // groups, cout // groups
        hi = self.lo + self.per
        segs: list = []
        for g in range(self.lo // opg, (hi - 1) // opg + 1):
            r0, r1 = max(self.lo, g * opg), min(hi, (g + 1) * opg)
            whole = r0 == g * opg and r1 == (g + 1) * opg
            if (whole and segs and segs[-1][4]
                    and segs[-1][1] == g):  # extend a run of whole groups
                g0, _, a, _, _ = segs[-1]
                segs[-1] = (g0, g + 1, a, r1 - self.lo, True)
            else:
                segs.append((g, g + 1, r0 - self.lo, r1 - self.lo, whole))
        return [(g0 * ipg, g1 * ipg, a, b, (g1 - g0) if whole else 1)
                for g0, g1, a, b, whole in segs]

    def _local(self, x):
        if not self.conv:
            return F.linear(x, self.weight)
        ys = [F.conv2d(x[:, c0:c1], self.weight[a:b], None, self.stride,
                       self.padding, self.dilation, groups)
              for c0, c1, a, b, groups in self.segments]
        return ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)

    def forward(self, x):
        x = _CopyToGroup.apply(x, self.group)
        dim = 1 if self.conv else x.dim() - 1
        y = _GatherDim.apply(self._local(x), dim, self.group, self.index,
                             self.n)
        if self.bias is not None:
            shape = [1] * y.dim()
            shape[dim] = -1
            y = y + self.bias.view(shape)
        return y


def _sharded(model) -> dict:
    return {name: m for name, m in model.named_modules()
            if isinstance(m, ColumnParallel)}


def shard_wide_kernels(model, mesh, axis: str = "model", min_width: int = 64,
                       module_patterns=WIDE_MODULE_PATTERNS):
    """Tensor-parallel placement over the mesh's ``axis``, in place: each
    layer whose weight :func:`wide_kernel_placement` shards becomes a
    :class:`ColumnParallel` holding this rank's slice; every other
    parameter stays whole. Returns ``model``. A mesh without the axis (or
    with it of size 1) leaves the model as it is."""
    n = axis_size(mesh, axis)
    if n <= 1:
        return model
    group, index = axis_group(mesh, axis), axis_index(mesh, axis)
    placed = wide_kernel_placement(model, n, min_width, module_patterns)
    for name, sharded in placed.items():
        if not sharded:
            continue
        path = name.rsplit(".", 1)[0]
        parent_name, _, child = path.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        parent.add_module(child, ColumnParallel(getattr(parent, child),
                                                group, index, n))
    return model


def sharded_names(model) -> dict:
    """``{weight name: ColumnParallel}`` of the model's sharded layers."""
    return {f"{name}.weight": m for name, m in _sharded(model).items()}


def full_tensor(module: ColumnParallel, local: torch.Tensor) -> torch.Tensor:
    """A ``(per, ...)`` tensor of ``module``'s rows gathered to the full
    ``(per * n, ...)`` one (a weight, or an optimizer moment)."""
    parts = [torch.empty_like(local.contiguous())
             for _ in range(module.n)]
    dist.all_gather(parts, local.contiguous(), group=module.group)
    return torch.cat(parts)


def gather_state_dict(model) -> dict:
    """The model's ``state_dict`` with every sharded weight gathered whole
    (a collective: every rank of the mesh calls it)."""
    shards = sharded_names(model)
    return {k: full_tensor(shards[k], v) if k in shards else v
            for k, v in model.state_dict().items()}


def local_state_dict(model, full: dict) -> dict:
    """A whole ``state_dict`` cut to this rank's slices of the sharded
    weights, ready for ``model.load_state_dict(..., strict=True)``."""
    shards = sharded_names(model)
    out = dict(full)
    for k, m in shards.items():
        out[k] = full[k][m.lo:m.lo + m.per]
    return out
