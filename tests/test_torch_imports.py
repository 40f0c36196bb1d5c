"""The port stands alone: ``sykepic_tpu_torch`` imports with JAX, flax,
optax, the JAX package, cv2 and scikit-learn blocked (the port depends on
none of them), no source of it names them, and its entry points never
carry on quietly on the CPU when a card was asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sykepic_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "sykepic_tpu", "cv2", "sklearn")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# Runs in a fresh interpreter: this process already holds jax (conftest).
_BLOCKER = f"""
import importlib, sys
BLOCKED = {BLOCKED!r}

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
names = sys.argv[1:]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_imports_with_jax_blocked():
    names = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py"))
    assert len(names) >= 37  # every module, not only the top level
    for new in ("sykepic_tpu_torch.train.loop", "sykepic_tpu_torch.utils.png",
                "sykepic_tpu_torch.ops.augment",
                "sykepic_tpu_torch.train.device_data"):
        assert new in names
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *names], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) == len(names)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_sources_name_no_jax(path):
    named = sorted(set(_imported_roots(path)) & set(BLOCKED))
    assert not named, f"{path} imports {named}"


def test_cuda_without_card_raises(model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is moot")
    from sykepic_tpu_torch import device
    from sykepic_tpu_torch.compute.engine import Classifier

    with pytest.raises(RuntimeError, match="CUDA"):
        Classifier(model_dir, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Classifier(model_dir)  # cuda is the default
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve(None)
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")
