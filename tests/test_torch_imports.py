"""The port stands alone: ``sykepic_tpu_torch`` imports with JAX, flax,
optax, the JAX package, cv2, scikit-learn and pandas blocked (the port
depends on none of them; the card machine has no pandas), no source of it
names the first six, pandas and matplotlib are imported only inside the
functions that need them, and its entry points never carry on quietly on
the CPU when a card was asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sykepic_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "sykepic_tpu", "cv2", "sklearn",
           "pandas")
# optional on the card machine: imported inside the functions needing them
LAZY = ("pandas", "matplotlib")


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
                "sykepic_tpu_torch.train.device_data",
                "sykepic_tpu_torch.parallel",
                "sykepic_tpu_torch.parallel.launch",
                "sykepic_tpu_torch.parallel.dryrun",
                "sykepic_tpu_torch.compute.features",
                "sykepic_tpu_torch.compute.feature",
                "sykepic_tpu_torch.compute.feature_matlab",
                "sykepic_tpu_torch.compute.watch",
                "sykepic_tpu_torch.models.export"):
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
    named = sorted(set(_imported_roots(path)) & (set(BLOCKED) - set(LAZY)))
    assert not named, f"{path} imports {named}"


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_optional_packages_imported_lazily(path):
    """pandas and matplotlib only inside a function: no statement of the
    module's top level (nor of a class body, an ``if`` or a ``try`` there)
    imports them."""
    tree = ast.parse(path.read_text(), filename=str(path))
    stack, top = list(tree.body), []
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            top.append(node)
        stack.extend(ast.iter_child_nodes(node))
    roots = {alias.name.split(".")[0] for n in top if isinstance(n, ast.Import)
             for alias in n.names}
    roots |= {n.module.split(".")[0] for n in top
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not roots & set(LAZY), f"{path} imports {sorted(roots & set(LAZY))}"


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


def test_mesh_on_cuda_without_card_raises(model_dir, tmp_path):
    """A mesh does not move the device rule: asking a Trainer or a
    Classifier for ``cuda`` with a mesh, or a NCCL group, raises without a
    card; a gloo group's mesh serves the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is moot")
    from sykepic_tpu_torch import parallel
    from sykepic_tpu_torch.compute.engine import Classifier
    from sykepic_tpu_torch.models import registry
    from sykepic_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.init_process_group("cuda", tmp_path / "nccl", 0, 1)
    assert not parallel.is_initialized()
    dev = parallel.init_process_group("cpu", tmp_path / "gloo", 0, 1)
    try:
        mesh = parallel.data_mesh()
        assert dev == torch.device("cpu")
        assert parallel.data_axis_size(mesh) == 1
        model = registry.build_model("resnet18", 3, head=(8,))
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(model, device="cuda", mesh=mesh)
        with pytest.raises(RuntimeError, match="CUDA"):
            Classifier(model_dir, device="cuda", mesh=mesh)
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(model)  # cuda is the default, mesh or not
        assert Trainer(model, device="cpu").mesh is not None  # the group's
    finally:
        parallel.destroy_process_group()


def test_dry_run_takes_the_cards_by_default(tmp_path):
    """The multi-process dry run is an entry point like the others: it runs
    on the cards unless asked for the CPU, and raises without a card
    before it spawns anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is moot")
    from sykepic_tpu_torch.parallel import dryrun

    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run(2, tmp_path)
    assert not any(tmp_path.iterdir())
