"""Every public top-level function and class of every module of
``sykepic_tpu/`` has its counterpart in ``sykepic_tpu_torch/``: the same name
in the port module of the same path, or an entry of :data:`MAPPED` naming
the port's ``module::name`` that takes its place. Both packages are parsed
with ``ast``; nothing is imported."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "sykepic_tpu"
PORT = REPO / "sykepic_tpu_torch"

_CHECKPOINT = "models/checkpoint.py"

# "JAX module::name" -> "port module::name" that does its work
MAPPED = {
    # the Flax <-> torch converters: one key map per family
    "models/convert_torch.py::normalize_state_dict":
        f"{_CHECKPOINT}::normalize_state_dict",
    **{f"models/convert_torch.py::torch_{fam}_to_flax":
       f"{_CHECKPOINT}::to_flax_variables"
       for fam in ("resnet", "efficientnet", "mobilenet_v3", "vgg",
                   "convnext", "alexnet", "regnet")},
    "models/convert_torch.py::torch_to_flax":
        f"{_CHECKPOINT}::to_flax_variables",
    **{f"models/convert_torch.py::flax_{fam}_to_torch":
       f"{_CHECKPOINT}::from_flax_variables"
       for fam in ("resnet", "efficientnet", "mobilenet_v3", "vgg",
                   "convnext", "alexnet", "regnet")},
    "models/convert_torch.py::flax_to_torch": "models/export.py::export",
    "models/convert_torch.py::save_pth": "models/export.py::export",
    "models/convert_torch.py::load_pth": f"{_CHECKPOINT}::load_model_state",
    # an unknown torch state dict raises in the family sniffer
    "models/convert_torch.py::UnsupportedArchitectureError":
        f"{_CHECKPOINT}::_torch_family",
    # the torchvision index layouts the converters walk
    "models/convnext.py::torch_feature_layout":
        f"{_CHECKPOINT}::_convnext_modules",
    "models/vgg.py::feature_index_map": f"{_CHECKPOINT}::_features_modules",
    # torch.nn.AdaptiveAvgPool2d inside the VGG module
    "models/vgg.py::adaptive_avg_pool": "models/vgg.py::VGG",
    "models/efficientnet.py::SqueezeExcite":
        "models/layers.py::SqueezeExcitation",
    "models/mobilenet.py::HardSqueezeExcite":
        "models/layers.py::SqueezeExcitation",
    "models/regnet.py::SqueezeExcite": "models/layers.py::SqueezeExcitation",
    "models/registry.py::init_variables": "models/registry.py::init_weights",
    "models/registry.py::head_in_features": "models/resnet.py::Head",
    "train/loop.py::load_pretrained": f"{_CHECKPOINT}::load_pretrained",
    "train/loop.py::merge_variables": f"{_CHECKPOINT}::merge_variables",
    # the two Pallas kernels and their VMEM planning: the CUDA kernels
    "ops/pallas_preprocess.py::resize_pad_batch_pallas":
        "ops/resize_pad.py::resize_pad",
    "ops/preprocess.py::resize_pad_batch_mxu": "ops/resize_pad.py::resize_pad",
    "ops/pallas_flood.py::flood_pallas": "ops/flood.py::flood",
    "ops/pallas_flood.py::padded_pixels": "ops/flood.py::shared_bytes",
    "ops/pallas_flood.py::fits_vmem": "ops/flood.py::pick_form",
    "ops/preprocess.py::mode_pixel": "ingest/pack.py::mode_pixel",
    # JAX's compilation cache -> the nvcc build cache
    "utils/jaxcache.py::enable": "ops/cuda_build.py::load",
}


def _public(path: Path) -> list:
    """Public top-level functions and classes of a module."""
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def _defined(path: Path) -> set:
    """Every name a module binds at top level: functions, classes,
    assignments and imports (a re-export counts)."""
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                     if _public(p))


def _port_has(entry: str) -> bool:
    module, name = entry.split("::")
    path = PORT / module
    return path.is_file() and name in _defined(path)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    missing = [name for name in _public(JAX / module)
               if not _port_has(MAPPED.get(f"{module}::{name}",
                                           f"{module}::{name}"))]
    assert not missing, f"sykepic_tpu/{module}: no counterpart for {missing}"


def test_every_mapped_entry_names_a_jax_name_and_a_port_name():
    for key, entry in MAPPED.items():
        module, name = key.split("::")
        assert (JAX / module).is_file() and name in _public(JAX / module), key
        assert not _port_has(key), (
            f"{key} has a namesake in the port; the entry is stale")
        assert _port_has(entry), f"{key} -> {entry}: not in the port"
