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
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np
import torch

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
