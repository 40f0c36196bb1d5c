"""The model-directory contract and checkpoint loading.

A model directory (the reference's shape, ``train/train.py:116-119``)::

    <model_dir>/
        config.ini          # architecture + preprocessing spec
        class_names.txt     # one class per line, LabelEncoder order
        best_state.msgpack  # the JAX package's checkpoint (flax msgpack)
        best_state.pth      # or: a reference torch checkpoint

Both formats load into one torch ``state_dict`` in torchvision naming
(:mod:`sykepic_tpu_torch.models.resnet`):

- ``best_state.msgpack`` is read by :func:`msgpack_restore`, a small decoder
  of flax's format written here (the ``msgpack`` package is not a
  dependency), and renamed by :func:`from_flax_variables`.
- ``best_state.pth`` in the reference ``base.N.*`` / ``head.K.*`` layout is
  renamed by :func:`normalize_state_dict`.

Training writes ``best_state.msgpack`` back in the JAX package's layout:
:func:`to_flax_variables` (the inverse of :func:`from_flax_variables`) and
:func:`msgpack_serialize`, a writer of flax's format (ndarray ext code 1,
scalars ext code 3, arrays over 1 GiB chunked), so
``sykepic_tpu.models.checkpoint.load_variables`` reads what the port
trains. :func:`merge_variables` and :func:`load_pretrained` resolve the
``[model] weights`` option over such trees.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np
import torch

from ..utils import logger

log = logger.get_logger("checkpoint")

BEST_STATE = "best_state.msgpack"
TORCH_STATE = "best_state.pth"

# base.N -> torchvision child name, for reference TorchVisionNet state dicts
# (base = Sequential(children[:-1]) of a torchvision resnet)
_BASE_CHILDREN = {
    "0": "conv1",
    "1": "bn1",
    "4": "layer1",
    "5": "layer2",
    "6": "layer3",
    "7": "layer4",
}

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def read_class_names(model_dir) -> list[str]:
    """``class_names.txt`` -> list (reference ``probability.py:120-121``)."""
    with open(Path(model_dir) / "class_names.txt") as fh:
        return fh.read().splitlines()


# ---------------------------------------------------------------------------
# flax msgpack
# ---------------------------------------------------------------------------

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """A msgpack decoder for the subset flax writes: nil, bool, ints,
    floats, str, bin, arrays, maps and ext types."""

    def __init__(self, data: bytes, raw: bool = False, ext_hook=None):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: self.take(self.unpack("B")),
            0xC5: lambda: self.take(self.unpack("H")),
            0xC6: lambda: self.take(self.unpack("I")),
            0xC7: lambda: self.ext(self.unpack("B")),
            0xC8: lambda: self.ext(self.unpack("H")),
            0xC9: lambda: self.ext(self.unpack("I")),
            0xCA: lambda: self.unpack("f"), 0xCB: lambda: self.unpack("d"),
            0xCC: lambda: self.unpack("B"), 0xCD: lambda: self.unpack("H"),
            0xCE: lambda: self.unpack("I"), 0xCF: lambda: self.unpack("Q"),
            0xD0: lambda: self.unpack("b"), 0xD1: lambda: self.unpack("h"),
            0xD2: lambda: self.unpack("i"), 0xD3: lambda: self.unpack("q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str(self.unpack("B")),
            0xDA: lambda: self.str(self.unpack("H")),
            0xDB: lambda: self.str(self.unpack("I")),
            0xDC: lambda: self.array(self.unpack("H")),
            0xDD: lambda: self.array(self.unpack("I")),
            0xDE: lambda: self.map(self.unpack("H")),
            0xDF: lambda: self.map(self.unpack("I")),
        }
        if b not in fixed:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return fixed[b]()

    def str(self, n: int):
        s = self.take(n)
        return s if self.raw else s.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if self.ext_hook is None:
            raise ValueError(f"msgpack ext type {code} without a hook")
        return self.ext_hook(code, data)


def _unpackb(data: bytes, raw: bool = False, ext_hook=None):
    reader = _Reader(data, raw=raw, ext_hook=ext_hook)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack value")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ``(shape, dtype name, C-order bytes)`` -> ndarray. bfloat16,
    which numpy lacks, widens exactly to float32."""
    shape, dtype_name, buffer = _unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = _unpackb(data)
        return complex(real, imag)
    raise ValueError(f"unknown flax msgpack ext type {code}")


def _unchunk(tree):
    """Reassemble flax's chunked form of arrays over 1 GiB."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The nested dict of ndarrays that ``flax.serialization.msgpack_restore``
    returns for the same bytes."""
    return _unchunk(_unpackb(data, ext_hook=_ext_hook))


# Arrays above this many bytes are split into chunks, as flax does
# (flax.serialization.MAX_CHUNK_SIZE).
MAX_CHUNK_SIZE = 2 ** 30


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -32 <= n < 0:
        return struct.pack("b", n)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, "B"), (-0x80, -1, 0xD0, "b"),
                              (0, 0xFFFF, 0xCD, "H"),
                              (-0x8000, -1, 0xD1, "h"),
                              (0, 0xFFFFFFFF, 0xCE, "I"),
                              (-0x80000000, -1, 0xD2, "i"),
                              (0, 2 ** 64 - 1, 0xCF, "Q"),
                              (-2 ** 63, -1, 0xD3, "q")):
        if lo <= n <= hi:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """Header of a str/bin/array/map of length ``n``: the fix form when
    ``fix`` is given and ``n <= fix_max``, else the 8/16/32-bit form of
    ``codes`` (a code of None: no such form)."""
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    for code, fmt, top in zip(codes, ("B", "H", "I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        head = struct.pack("B", fixed[len(data)])
    else:
        head = _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code) + data


def _packb(obj) -> bytes:
    """msgpack bytes of ``obj`` as ``msgpack.packb(obj, use_bin_type=True,
    default=flax's ext packer)`` writes them."""
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _ndarray_to_bytes(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return struct.pack(">Bd", 0xCB, obj)
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, (bytes, bytearray)):
        return _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return (_pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD))
                + b"".join(_packb(v) for v in obj))
    if isinstance(obj, dict):
        return (_pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF))
                + b"".join(_packb(k) + _packb(v) for k, v in obj.items()))
    raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's ``(shape, dtype name, C-order bytes)`` encoding."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved")
    return _packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                   arr.tobytes("C")))


def _chunked(tree):
    """A new tree with flax's layout: dict keys in sorted order (flax maps
    the tree through ``jax.tree_util`` first, which sorts them) and array
    leaves over :data:`MAX_CHUNK_SIZE` bytes in flax's chunked form."""
    if isinstance(tree, dict):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a
    nested dict of numpy arrays (and python scalars)."""
    return _packb(_chunked(tree))


def save_variables(path, variables) -> None:
    """Write a ``{"params", "batch_stats"}`` tree of numpy leaves as flax
    msgpack (the JAX package's ``save_variables``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(variables))


def load_variables(path) -> dict:
    """The nested dict of ndarrays in a flax msgpack file."""
    return msgpack_restore(Path(path).read_bytes())


# ---------------------------------------------------------------------------
# key mapping
# ---------------------------------------------------------------------------

def head_linear_indices(n_linears: int, dropout=()) -> list[int]:
    """torch Sequential index of each head Linear after the reference's
    Dropout insertions (``network.py:58-61``: Dropouts are list.insert()ed
    at the spec's indices, shifting later Linears)."""
    layers = [("L", i) for i in range(n_linears)]
    for idx, _p in dropout:
        layers.insert(int(idx), ("D", None))
    return [pos for pos, (kind, _) in enumerate(layers) if kind == "L"]


def normalize_state_dict(state_dict: dict) -> dict:
    """Rewrite reference ``base.N.*`` keys into torchvision naming
    (``conv1.*`` / ``layerX.Y.*``); ``head.K.*`` is kept as it is."""
    out = {}
    for key, value in state_dict.items():
        m = re.match(r"^base\.(\d+)\.(.*)$", key)
        if m:
            child = _BASE_CHILDREN.get(m.group(1))
            if child is None:  # relu / maxpool / avgpool have no params
                continue
            key = f"{child}.{m.group(2)}"
        out[key] = value
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _conv(kernel) -> torch.Tensor:
    """flax (kH, kW, I, O) -> torch (O, I, kH, kW)."""
    return _tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


def _put_bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    for leaf, tree in (("scale", params), ("bias", params), ("mean", stats),
                       ("var", stats)):
        sd[f"{prefix}.{_BN_LEAVES[leaf]}"] = _tensor(tree[leaf])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def from_flax_variables(variables: dict, dropout=()) -> dict:
    """The JAX package's ResNet variable tree (``{"params", "batch_stats"}``
    of numpy leaves) -> a torch ``state_dict`` for
    :class:`sykepic_tpu_torch.models.resnet.ResNet`.

    Conv kernels (kH, kW, I, O) -> (O, I, kH, kW); Dense (I, O) -> (O, I);
    BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
    running_var``; ``layer{i}_{j}`` -> ``layer{i}.{j}``;
    ``downsample_conv/bn`` -> ``downsample.0/1``; head ``fc{k}`` ->
    ``head.K`` with the Dropout positions of ``dropout`` skipped.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if "conv1" not in params:
        raise NotImplementedError(
            "only ResNet-family checkpoints are ported; the other families "
            "are ROADMAP slice 5")
    sd: dict = {"conv1.weight": _conv(params["conv1"]["kernel"])}
    _put_bn(sd, "bn1", params["bn1"], stats["bn1"])
    for mod, tree in params.items():
        m = re.match(r"^layer(\d+)_(\d+)$", mod)
        if m is None:
            continue
        prefix = f"layer{m.group(1)}.{m.group(2)}"
        for sub, leaf in tree.items():
            if sub.startswith("conv"):
                sd[f"{prefix}.{sub}.weight"] = _conv(leaf["kernel"])
            elif sub.startswith("bn"):
                _put_bn(sd, f"{prefix}.{sub}", leaf, stats[mod][sub])
            elif sub == "downsample_conv":
                sd[f"{prefix}.downsample.0.weight"] = _conv(leaf["kernel"])
            elif sub == "downsample_bn":
                _put_bn(sd, f"{prefix}.downsample.1", leaf, stats[mod][sub])
            else:
                raise KeyError(f"Unhandled module {mod}.{sub}")
    head = params.get("head", {})
    for k, idx in enumerate(head_linear_indices(len(head), dropout)):
        fc = head[f"fc{k}"]
        sd[f"head.{idx}.weight"] = _tensor(np.asarray(fc["kernel"]).T)
        sd[f"head.{idx}.bias"] = _tensor(fc["bias"])
    return sd


def flax_path(key: str, head_rank: dict) -> tuple:
    """``(collection, module path..., leaf)`` of torch ``state_dict`` key
    ``key`` in the JAX package's variable tree: the inverse renaming of
    :func:`from_flax_variables`. ``head_rank`` maps a head Sequential index
    to its Linear's rank ``k`` (``fc{k}``). Raises ``KeyError`` for a key
    outside the ResNet layout."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "head":
        if len(parts) != 3 or leaf not in ("weight", "bias"):
            raise KeyError(key)
        fc = f"fc{head_rank[int(parts[1])]}"
        return ("params", "head", fc, "kernel" if leaf == "weight" else
                "bias")
    if parts[0] in ("conv1", "bn1"):
        mod = [parts[0]]
        sub = parts[0]
    elif re.match(r"^layer\d+$", parts[0]) and len(parts) >= 4:
        block = f"{parts[0]}_{parts[1]}"
        if parts[2] == "downsample":
            sub = {"0": "downsample_conv", "1": "downsample_bn"}[parts[3]]
        else:
            sub = parts[2]
        mod = [block, sub]
    else:
        raise KeyError(key)
    if sub.startswith("conv") or sub == "downsample_conv":
        if leaf != "weight":
            raise KeyError(key)
        return ("params", *mod, "kernel")
    if leaf in ("running_mean", "running_var"):
        return ("batch_stats", *mod, "mean" if leaf == "running_mean" else
                "var")
    if leaf in ("weight", "bias"):
        return ("params", *mod, "scale" if leaf == "weight" else "bias")
    raise KeyError(key)


def head_ranks(keys) -> dict:
    """Head Sequential index -> Linear rank, from ``head.K.weight`` keys."""
    idx = sorted({int(k.split(".")[1]) for k in keys
                  if k.startswith("head.") and k.endswith(".weight")})
    return {k: r for r, k in enumerate(idx)}


def to_flax_variables(state_dict: dict) -> dict:
    """A torch ``state_dict`` of :class:`~sykepic_tpu_torch.models.resnet.
    ResNet` -> the JAX package's ``{"params", "batch_stats"}`` tree of
    float32 numpy leaves (the inverse of :func:`from_flax_variables`):
    conv (O, I, kH, kW) -> (kH, kW, I, O), Linear (O, I) -> (I, O),
    BatchNorm ``weight/bias/running_mean/running_var`` ->
    ``scale/bias/mean/var``. ``num_batches_tracked`` has no counterpart and
    is dropped."""
    ranks = head_ranks(state_dict)
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        path = flax_path(key, ranks)
        a = value.detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def merge_variables(init_vars, loaded_vars):
    """Copy leaves from ``loaded_vars`` whose path+shape match ``init_vars``
    (the classification head keeps its fresh init when class counts
    differ; ``sykepic_tpu/train/loop.py:568-582``)."""
    init_flat = _flatten(init_vars)
    loaded_flat = _flatten(loaded_vars)
    merged = {}
    for path, leaf in init_flat.items():
        cand = loaded_flat.get(path)
        if cand is not None and np.shape(cand) == np.shape(leaf):
            merged[path] = np.asarray(cand)
        else:
            merged[path] = leaf
    return _unflatten(merged)


def load_pretrained(variables, weights_spec, network_name: str,
                    allow_random_init: bool = False):
    """Resolve the ``[model] weights`` option over a variable tree
    (``sykepic_tpu/train/loop.py:513-565``; reference ``config.py:63-70``).

    - empty/None: random init (the explicit way to ask for it);
    - a path to ``.msgpack``/``.pth``: load and merge matching leaves (a
      torchvision-layout ``.pth`` loses its ``fc`` classifier, which the
      head replaces);
    - a torchvision weights name ("DEFAULT", "IMAGENET1K_V1", ...): the
      port does not depend on torchvision, so this raises
      unless ``[model] allow_random_init`` is set, which trains from random
      init with a warning.
    """
    if not weights_spec:
        return variables
    path = Path(str(weights_spec))
    if path.suffix in (".msgpack", ".pth"):
        if not path.is_file():
            raise FileNotFoundError(
                f"[model] weights checkpoint not found: {path}")
        if path.suffix == ".msgpack":
            return merge_variables(variables, load_variables(path))
        sd = normalize_state_dict(torch.load(path, map_location="cpu",
                                             weights_only=True))
        sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
        return merge_variables(variables, to_flax_variables(sd))
    if allow_random_init:
        log.warning(
            f"Pretrained weights '{weights_spec}' ({network_name}) need "
            "torchvision, which the port does not use; training from random "
            "init ([model] allow_random_init is set)")
        return variables
    raise RuntimeError(
        f"Cannot load pretrained weights '{weights_spec}': the port has no "
        "torchvision. Point [model] weights at a .msgpack/.pth checkpoint, "
        "or set [model] allow_random_init = yes to knowingly train from "
        "scratch.")


def load_model_state(model_dir, dropout=(), device="cpu") -> dict:
    """``best_state`` of a model dir as a torch ``state_dict`` on
    ``device``: the msgpack checkpoint first, the reference ``.pth`` as the
    fallback. ``dropout`` is the dir's ``[model] dropout`` spec, which
    places the msgpack head's Linears at their ``head.K`` indices."""
    model_dir = Path(model_dir)
    native = model_dir / BEST_STATE
    if native.is_file():
        sd = from_flax_variables(msgpack_restore(native.read_bytes()),
                                 dropout)
    elif (model_dir / TORCH_STATE).is_file():
        sd = normalize_state_dict(torch.load(
            model_dir / TORCH_STATE, map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(
            f"No {BEST_STATE} or {TORCH_STATE} in {model_dir}")
    return {k: v.to(device) for k, v in sd.items()}
