"""The model-directory contract and checkpoint loading.

A model directory (the reference's shape, ``train/train.py:116-119``)::

    <model_dir>/
        config.ini          # architecture + preprocessing spec
        class_names.txt     # one class per line, LabelEncoder order
        best_state.msgpack  # the JAX package's checkpoint (flax msgpack)
        best_state.pth      # or: a reference torch checkpoint

Both formats load into one torch ``state_dict`` in torchvision naming
(every family of :mod:`sykepic_tpu_torch.models.registry`):

- ``best_state.msgpack`` is read by :func:`msgpack_restore`, a small decoder
  of flax's format written here (the ``msgpack`` package is not a
  dependency), and renamed by :func:`from_flax_variables`.
- ``best_state.pth`` in the reference ``base.N.*`` / ``head.K.*`` layout is
  renamed by :func:`normalize_state_dict`.

Swin (``swin_*``) has no Flax form: its checkpoint is the ``.pth`` alone,
and the Flax paths (:func:`flax_paths` and what reads it,
:func:`sniff_network`) refuse it.

Training writes ``best_state.msgpack`` back in the JAX package's layout:
:func:`to_flax_variables` (the inverse of :func:`from_flax_variables`) and
:func:`msgpack_serialize`, a writer of flax's format (ndarray ext code 1,
scalars ext code 3, arrays over 1 GiB chunked), so
``sykepic_tpu.models.checkpoint.load_variables`` reads what the port
trains. :func:`merge_variables` and :func:`load_pretrained` resolve the
``[model] weights`` option over such trees.
"""

from __future__ import annotations

import functools
import re
import struct
from pathlib import Path

import numpy as np
import torch

from ..utils import logger

log = logger.get_logger("checkpoint")

BEST_STATE = "best_state.msgpack"
TORCH_STATE = "best_state.pth"


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
#
# Every family's torch modules keep torchvision's names, and one map per
# family turns a torch module prefix into its module path in the JAX
# package's Flax tree (the port's copy of the key rules of
# ``sykepic_tpu/models/convert_torch.py``). :func:`flax_paths` adds the
# leaf rule that all families share; :func:`to_flax_variables` and
# :func:`from_flax_variables` both read it, so the two directions cannot
# drift apart.

# family -> the network-name prefixes of the registry that belong to it
FAMILIES = {
    "resnet": ("resnet", "resnext", "wide_resnet"),
    "efficientnet": ("efficientnet",),
    "mobilenet": ("mobilenet_v3",),
    "features": ("vgg", "alexnet"),
    "convnext": ("convnext",),
    "regnet": ("regnet",),
    "swin": ("swin",),
}

# reference TorchVisionNet ``base.N`` -> torchvision child, per family
# (``base = Sequential(children[:-1])``; relu / pools hold no parameters)
_BASE_CHILDREN = {
    "resnet": {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
               "6": "layer3", "7": "layer4"},
    "regnet": {"0": "stem", "1": "trunk_output"},
    "swin": {"0": "features", "1": "norm"},
    "features": {"0": "features"},  # and every family but those three
}
NO_FLAX = ("Swin has no Flax form (the JAX package has no Swin): its "
           "checkpoint is a best_state.pth in the reference's layout")

# a Flax module that normalises: its "weight" is a "scale"
_NORM = re.compile(r"(^|_)(bn\d*|ln|norm)$")


def family(network: str) -> str:
    """The key-map family of a registry name."""
    for fam, prefixes in FAMILIES.items():
        if network.startswith(prefixes):
            return fam
    raise ValueError(f"no key map for network '{network}'")


def _torch_family(keys) -> str:
    """The family of a torch state dict, from its keys."""
    keys = list(keys)
    if "conv1.weight" in keys:
        return "resnet"
    for fam, pattern in (("swin", r".*relative_position_bias_table$"),
                         ("regnet", r"trunk_output\."),
                         ("convnext", r".*layer_scale$"),
                         ("efficientnet", r"features\.\d+\.\d+\.block\."),
                         ("mobilenet", r"features\.\d+\.block\."),
                         ("features", r"features\.\d+\.weight$")):
        if any(re.match(pattern, k) for k in keys):
            return fam
    raise KeyError(f"state dict of no known family; keys {keys[:3]}")


def _resnet_modules(prefixes) -> dict:
    out = {}
    for p in prefixes:
        parts = p.split(".")
        if p in ("conv1", "bn1"):
            out[p] = (p,)
        elif len(parts) == 3 and re.fullmatch(r"layer\d+", parts[0]):
            out[p] = (f"{parts[0]}_{parts[1]}", parts[2])
        elif len(parts) == 4 and parts[2] == "downsample":
            out[p] = (f"{parts[0]}_{parts[1]}",
                      ("downsample_conv", "downsample_bn")[int(parts[3])])
        else:
            raise KeyError(p)
    return out


def _block_modules(prefixes, block_name, fused_without_se: bool) -> dict:
    """EfficientNet and MobileNetV3: ``features.0`` the stem, another
    ``features.N`` without ``.block`` the head conv, and blocks whose
    ``block.{i}`` units play the roles [expand] dw [se] project (MBConv) or
    fused [project] (EfficientNetV2's FusedMBConv: no squeeze-excitation).
    The roles come from the units present, as the JAX converters find
    them. ``block_name`` maps a block prefix to its Flax module."""
    units: dict = {}
    for p in prefixes:
        if ".block." in p:
            blk, rest = p.split(".block.")
            unit, sub = rest.split(".")
            units.setdefault(blk, {}).setdefault(int(unit), set()).add(sub)
    roles = {}
    for blk, by_unit in units.items():
        se = [i for i, subs in by_unit.items() if "fc1" in subs]
        convs = sorted(i for i in by_unit if i not in se)
        if se or not fused_without_se:
            names = (["expand", "dw", "project"] if len(convs) == 3
                     else ["dw", "project"])
        else:
            names = ["fused", "project"]
        roles[blk] = {**dict(zip(convs, names)), **{i: "se" for i in se}}
    out = {}
    for p in prefixes:
        if ".block." in p:
            blk, rest = p.split(".block.")
            unit, sub = rest.split(".")
            role = roles[blk][int(unit)]
            out[p] = ((block_name(blk), "se", sub) if role == "se" else
                      (block_name(blk),
                       f"{role}_{'conv' if sub == '0' else 'bn'}"))
        else:
            m = re.fullmatch(r"features\.(\d+)\.([01])", p)
            if m is None:
                raise KeyError(p)
            out[p] = (("stem" if m[1] == "0" else "head")
                      + ("_conv", "_bn")[int(m[2])],)
    return out


def _efficientnet_modules(prefixes) -> dict:
    def name(blk):  # features.G.R
        _, g, r = blk.split(".")
        return f"layer{g}_{r}"
    return _block_modules(prefixes, name, fused_without_se=True)


def _mobilenet_modules(prefixes) -> dict:
    def name(blk):  # features.I
        return f"layer{blk.split('.')[1]}_0"
    return _block_modules(prefixes, name, fused_without_se=False)


def _features_modules(prefixes) -> dict:
    """VGG and AlexNet: a ``features`` Sequential of Conv [BatchNorm] ReLU
    with max pools between the stages. A BatchNorm sits right after its
    conv; a conv further from the previous one than conv [bn] relu follows
    a pool and opens the next stage: ``layer{stage}_conv{j}`` /
    ``layer{stage}_bn{j}`` (``sykepic_tpu/models/vgg.py::
    feature_index_map``, ``alexnet.py:36-47``)."""
    idx = sorted(int(p.split(".")[1]) for p in prefixes)
    bn = any(b - a == 1 for a, b in zip(idx, idx[1:]))
    step = 3 if bn else 2
    out, stage, j, prev = {}, 1, -1, None
    for i in idx:
        if prev is not None and i == prev + 1:
            out[f"features.{i}"] = (f"layer{stage}_bn{j}",)
            continue
        if prev is not None and i - prev > step:
            stage, j = stage + 1, -1
        j += 1
        out[f"features.{i}"] = (f"layer{stage}_conv{j}",)
        prev = i
    if set(out) != set(prefixes):
        raise KeyError(sorted(set(prefixes) - set(out)))
    return out


_CNBLOCK_UNITS = {"0": "dwconv", "2": "norm", "3": "mlp1", "5": "mlp2"}


def _convnext_modules(prefixes) -> dict:
    """``features`` = [stem, stage 1, down 2, stage 2, down 3, stage 3,
    down 4, stage 4]; a downsample is [LayerNorm, conv]."""
    out = {}
    for p in prefixes:
        parts = p.split(".")
        fi = int(parts[1])
        if fi == 0:
            out[p] = (("stem_conv", "stem_ln")[int(parts[2])],)
        elif fi % 2 == 0:
            out[p] = (f"layer{fi // 2 + 1}_down_"
                      + ("norm", "conv")[int(parts[2])],)
        else:
            mod = f"layer{(fi + 1) // 2}_{parts[2]}"
            out[p] = ((mod,) if len(parts) == 3
                      else (mod, _CNBLOCK_UNITS[parts[4]]))
    return out


def _regnet_modules(prefixes) -> dict:
    out = {}
    for p in prefixes:
        if p in ("stem.0", "stem.1"):
            out[p] = (("stem_conv", "stem_bn")[int(p[-1])],)
            continue
        m = re.fullmatch(r"trunk_output\.block(\d+)\.block\1-(\d+)\."
                         r"(proj|f\.[abc]|f\.se)\.(\w+)", p)
        if m is None:
            raise KeyError(p)
        unit = m[3].split(".")[-1]
        mod = f"layer{m[1]}_{m[2]}"
        out[p] = ((mod, "se", m[4]) if unit == "se" else
                  (mod, f"{unit}_{'conv' if m[4] == '0' else 'bn'}"))
    return out


_MODULES = {"resnet": _resnet_modules, "efficientnet": _efficientnet_modules,
            "mobilenet": _mobilenet_modules, "features": _features_modules,
            "convnext": _convnext_modules, "regnet": _regnet_modules}


def head_linear_indices(n_linears: int, dropout=()) -> list[int]:
    """torch Sequential index of each head Linear after the reference's
    Dropout insertions (``network.py:58-61``: Dropouts are list.insert()ed
    at the spec's indices, shifting later Linears)."""
    layers = [("L", i) for i in range(n_linears)]
    for idx, _p in dropout:
        layers.insert(int(idx), ("D", None))
    return [pos for pos, (kind, _) in enumerate(layers) if kind == "L"]


def head_ranks(keys) -> dict:
    """Head Sequential index -> Linear rank, from ``head.K.weight`` keys."""
    idx = sorted({int(k.split(".")[1]) for k in keys
                  if k.startswith("head.") and k.endswith(".weight")})
    return {k: r for r, k in enumerate(idx)}


def _leaf_path(module: tuple, leaf: str) -> tuple:
    if leaf in ("running_mean", "running_var"):
        return ("batch_stats", *module, leaf.split("_")[1])
    if leaf == "weight":
        return ("params", *module,
                "scale" if _NORM.search(module[-1]) else "kernel")
    if leaf in ("bias", "layer_scale"):
        return ("params", *module, leaf)
    raise KeyError(leaf)


def flax_paths(keys, network: str | None = None) -> dict:
    """``(collection, module path..., leaf)`` in the JAX package's variable
    tree for each torch ``state_dict`` key (``num_batches_tracked``, which
    has no counterpart, is left out). The family comes from ``network``,
    else from the keys. Leaves: a convolution's or Linear's ``weight`` is
    its ``kernel``, a norm's ``weight`` its ``scale``, ``running_mean`` /
    ``running_var`` are ``batch_stats`` ``mean`` / ``var``; head Linear
    ``head.K`` is ``head/fc{rank}``. Raises ``KeyError`` for a key outside
    the family's layout."""
    keys = [k for k in keys if not k.endswith("num_batches_tracked")]
    fam = family(network) if network else _torch_family(keys)
    if fam == "swin":
        raise ValueError(NO_FLAX)
    split = {k: k.rsplit(".", 1) for k in keys}
    body = sorted({p for p, _ in split.values() if not p.startswith("head.")})
    modules = _MODULES[fam](body)
    ranks = head_ranks(keys)
    out = {}
    for key, (prefix, leaf) in split.items():
        if prefix.startswith("head."):
            parts = prefix.split(".")
            if len(parts) != 2 or leaf not in ("weight", "bias"):
                raise KeyError(key)
            module = ("head", f"fc{ranks[int(parts[1])]}")
        else:
            module = modules[prefix]
        out[key] = _leaf_path(module, leaf)
    return out


def normalize_state_dict(state_dict: dict, network: str | None = None) -> dict:
    """Rewrite reference ``base.N.*`` keys into torchvision naming: for
    ResNets ``base.0`` is ``conv1`` and ``base.4..7`` are ``layer1..4``;
    for RegNets ``base.0``/``base.1`` are ``stem``/``trunk_output``; for
    the other families ``base.0`` is ``features``
    (``sykepic_tpu/models/convert_torch.py:59,157,767``). ``head.K.*`` is
    kept as it is. The family comes from ``network``, else from the
    keys."""
    if network:
        fam = family(network)
    elif "base.0.weight" in state_dict:  # a ResNet's conv1
        fam = "resnet"
    elif any(re.match(r"base\.1\.block\d+\.", k) for k in state_dict):
        fam = "regnet"
    elif any(k.endswith("relative_position_bias_table") for k in state_dict):
        fam = "swin"
    else:
        fam = "features"
    children = _BASE_CHILDREN.get(fam, _BASE_CHILDREN["features"])
    out = {}
    for key, value in state_dict.items():
        m = re.match(r"^base\.(\d+)\.(.*)$", key)
        if m:
            child = children.get(m.group(1))
            if child is None:  # relu / maxpool / avgpool have no params
                continue
            key = f"{child}.{m.group(2)}"
        out[key] = value
    return _with_swin_index(out) if fam == "swin" else out


def _with_swin_index(state_dict: dict) -> dict:
    """Each Swin attention's ``relative_position_index`` buffer, computed
    from the window its bias table implies: added where the checkpoint
    lacks it (a reference net's parameters alone), held against it where
    the checkpoint has it (torchvision's ``state_dict``); a buffer that
    differs raises ``ValueError``."""
    from .swin import relative_position_index

    out = dict(state_dict)
    for key, table in state_dict.items():
        if not key.endswith(".relative_position_bias_table"):
            continue
        window = (round(table.shape[0] ** 0.5) + 1) // 2
        want = relative_position_index(window)
        name = key.removesuffix("bias_table") + "index"
        have = out.setdefault(name, want)
        if tuple(have.shape) != tuple(want.shape) or not torch.equal(
                have.to("cpu", torch.long), want):
            raise ValueError(f"{name} is not the relative position index "
                             f"of a {window}x{window} window")
    return out


def reference_state_dict(state_dict: dict,
                         network: str | None = None) -> dict:
    """The inverse of :func:`normalize_state_dict`: torchvision naming ->
    the reference ``TorchVisionNet`` layout (``base.N.*``, ``head.K.*``
    kept), as ``sykepic_tpu/models/convert_torch.py::flax_to_torch``
    writes it. The family comes from ``network``, else from the keys."""
    fam = family(network) if network else _torch_family(state_dict)
    children = _BASE_CHILDREN.get(fam, _BASE_CHILDREN["features"])
    base = {child: idx for idx, child in children.items()}
    out = {}
    for key, value in state_dict.items():
        child, _, rest = key.partition(".")
        out[key if child == "head" else f"base.{base[child]}.{rest}"] = value
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


@functools.lru_cache(maxsize=None)
def _backbone_shapes(network: str) -> dict:
    """Key -> shape of ``network``'s state dict without the head, from a
    model built on the meta device (no memory, no initialisation)."""
    from .registry import build_model

    with torch.device("meta"):
        model = build_model(network, 1, head=())
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.startswith("head.")}


def _flax_family(params: dict) -> str:
    """The family of a Flax variable tree (the sniffers of
    ``convert_torch.flax_to_torch``, ``:1157-1174``)."""
    if any("relative_position_bias_table" in name
           for path in _flatten(params) for name in path):
        raise ValueError(NO_FLAX)
    layers = [m for m in params if re.fullmatch(r"layer\d+_\d+", m)]
    if "stem_ln" in params:
        return "convnext"
    if any("a_conv" in params[m] for m in layers):
        return "regnet"
    if "conv1" in params:
        return "resnet"
    if any(re.fullmatch(r"layer\d+_conv\d+", m) for m in params):
        return "features"
    if "stem_conv" in params:
        # MobileNetV3 trees hold single-repeat blocks, some without SE
        if (layers and all(m.endswith("_0") for m in layers)
                and any("se" not in params[m] for m in layers)):
            return "mobilenet"
        return "efficientnet"
    raise KeyError(f"variable tree of no known family: {sorted(params)[:8]}")


def _fits(variables: dict, network: str) -> bool:
    """Whether ``network``'s backbone is exactly the tree's, leaf by leaf."""
    shapes = _backbone_shapes(network)
    paths = flax_paths(shapes, network)
    want = {path: int(np.prod(shapes[k])) for k, path in paths.items()}
    have = {p: int(np.size(v)) for p, v in _flatten(variables).items()
            if p[1] != "head"}
    return want == have


def sniff_network(variables: dict) -> str:
    """The registry name whose backbone matches the variable tree's."""
    from .registry import MODEL_REGISTRY

    fam = _flax_family(variables["params"])
    for name in MODEL_REGISTRY:
        if family(name) == fam and _fits(variables, name):
            return name
    raise ValueError(f"no {fam} network of the registry matches the "
                     "variable tree")


def from_flax_variables(variables: dict, dropout=(),
                        network: str | None = None) -> dict:
    """The JAX package's variable tree (``{"params", "batch_stats"}`` of
    numpy leaves) -> a torch ``state_dict`` for ``network`` (sniffed from
    the tree when not given), by :func:`flax_paths` over the network's own
    keys: conv kernels (kH, kW, I, O) -> (O, I, kH, kW); Dense (I, O) ->
    (O, I); ConvNeXt's ``layer_scale`` (C,) -> (C, 1, 1); head ``fc{k}`` ->
    ``head.K`` with the Dropout positions of ``dropout`` skipped. A leaf of
    another shape, or a backbone leaf the network lacks, raises."""
    network = network or sniff_network(variables)
    shapes = _backbone_shapes(network)
    paths = flax_paths(shapes, network)
    sd: dict = {}
    used = set()
    for key, shape in shapes.items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(0, dtype=torch.long)
            continue
        path = paths[key]
        node = variables
        for name in path:
            node = node[name]
        a = np.asarray(node, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        if a.shape != shape and not (path[-1] == "layer_scale"
                                     and a.size == np.prod(shape)):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape} for "
                             f"{network}'s {key} {shape}")
        sd[key] = _tensor(a.reshape(shape))
        used.add(path)
    extra = [p for p in _flatten(variables) if p[1] != "head" and p not in used]
    if extra:
        raise ValueError(f"{network} has no {'/'.join(extra[0])} "
                         f"({len(extra)} such leaves)")
    head = variables["params"].get("head", {})
    for k, idx in enumerate(head_linear_indices(len(head), dropout)):
        fc = head[f"fc{k}"]
        sd[f"head.{idx}.weight"] = _tensor(np.asarray(fc["kernel"]).T)
        sd[f"head.{idx}.bias"] = _tensor(fc["bias"])
    return sd


def to_flax_variables(state_dict: dict, network: str | None = None) -> dict:
    """A torch ``state_dict`` -> the JAX package's ``{"params",
    "batch_stats"}`` tree of float32 numpy leaves (the inverse of
    :func:`from_flax_variables`, by the same :func:`flax_paths`): conv
    (O, I, kH, kW) -> (kH, kW, I, O), Linear (O, I) -> (I, O),
    ``layer_scale`` (C, 1, 1) -> (C,). A family without BatchNorm keeps an
    empty ``batch_stats``, as the JAX trainer saves it."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, path in flax_paths(state_dict, network).items():
        a = state_dict[key].detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        elif path[-1] == "layer_scale":
            a = a.reshape(-1)
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
      torchvision-layout ``.pth`` loses its ``fc`` or ``classifier``, which
      the head replaces);
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
                                             weights_only=True), network_name)
        sd = {k: v for k, v in sd.items()
              if not k.startswith(("fc.", "classifier."))}
        return merge_variables(variables,
                               to_flax_variables(sd, network_name))
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


def load_model_state(model_dir, dropout=(), device="cpu",
                     network: str | None = None) -> dict:
    """``best_state`` of a model dir as a torch ``state_dict`` on
    ``device``: the msgpack checkpoint first, the reference ``.pth`` as the
    fallback. ``dropout`` is the dir's ``[model] dropout`` spec, which
    places the msgpack head's Linears at their ``head.K`` indices;
    ``network`` is its ``[model] network``, which picks the key map (the
    checkpoint is sniffed without it)."""
    model_dir = Path(model_dir)
    native = model_dir / BEST_STATE
    if native.is_file():
        sd = from_flax_variables(msgpack_restore(native.read_bytes()),
                                 dropout, network)
    elif (model_dir / TORCH_STATE).is_file():
        sd = normalize_state_dict(torch.load(
            model_dir / TORCH_STATE, map_location="cpu", weights_only=True),
            network)
    else:
        raise FileNotFoundError(
            f"No {BEST_STATE} or {TORCH_STATE} in {model_dir}")
    return {k: v.to(device) for k, v in sd.items()}
