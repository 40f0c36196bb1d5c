"""``python -m sykepic_tpu_torch export`` (``sykepic_tpu_torch/models/
export.py``) against the JAX package's exporter, for one name of each
family at the small sizes of ``tests/torch_families.py`` (64x64, head 16,8
with Dropout before the last Linear, 5 classes; seeded weights): the port's
``best_state.pth`` holds the keys of ``convert_torch.flax_to_torch`` on
the same ``best_state.msgpack``, tensors exactly equal (``num_batches_tracked``
included); ``convert_torch.load_pth`` reads it back to the same tree; a
directory holding only ``config.ini``, ``class_names.txt`` and that
``.pth`` gives the port exactly the logits of the msgpack directory; the
CLI writes ``<model>/best_state.pth`` by default and ``-o`` elsewhere.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_families as tf
from sykepic_tpu.models import checkpoint as jax_checkpoint
from sykepic_tpu.models import convert_torch
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.models import checkpoint, export
from sykepic_tpu_torch.train import config as tcfg

NAMES = ("resnet18", "efficientnet_b0", "mobilenet_v3_small", "vgg11_bn",
         "alexnet", "convnext_tiny", "regnet_y_400mf")
MODEL_SRC = Path("tests/model/resnet18_ref")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def model_dir(root: Path, name: str) -> tuple[Path, dict]:
    """A JAX-written model directory of ``name`` at the families' test
    size; returns it and its variable tree."""
    d = root / name
    d.mkdir(parents=True)
    text = (MODEL_SRC / "config.ini").read_text()
    for old, new in (("network = resnet18", f"network = {name}"),
                     ("head = 256, 128", "head = 16, 8"),
                     ("dropout =", "dropout = -1, 0.5"),
                     ("shape = 3, 180, 180", f"shape = 3, {tf.SIZE}, "
                                             f"{tf.SIZE}")):
        assert old in text
        text = text.replace(old, new)
    (d / "config.ini").write_text(text)
    (d / "class_names.txt").write_text(
        "\n".join(f"class_{i}" for i in range(tf.NUM_CLASSES)) + "\n")
    variables = tf.random_variables(name)
    jax_checkpoint.save_variables(d / "best_state.msgpack", variables)
    return d, variables


def logits(d: Path, x: torch.Tensor) -> torch.Tensor:
    """The port's eval forward on the directory's checkpoint."""
    config = tcfg.read_config(d / "config.ini")
    model, _ = tcfg.get_network(config, tf.NUM_CLASSES)
    _, dropout = tcfg.get_head_spec(config)
    model.load_state_dict(checkpoint.load_model_state(
        d, dropout, network=model.network), strict=True)
    with torch.inference_mode():
        return model.eval()(x)


@pytest.mark.parametrize("name", NAMES)
def test_export_equals_jax_and_reloads(name, tmp_path):
    d, variables = model_dir(tmp_path, name)
    out = export.export(d, tmp_path / "port.pth")
    got = torch.load(out, map_location="cpu", weights_only=True)
    want = convert_torch.flax_to_torch(variables, tf.DROPOUT, name)
    assert got.keys() == want.keys()
    assert any(k.startswith("base.") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    # the JAX package reads the file back to the same tree
    back = checkpoint._flatten(convert_torch.load_pth(out, name))
    flat = checkpoint._flatten(variables)
    assert back.keys() == flat.keys()
    for path in flat:
        np.testing.assert_array_equal(back[path], flat[path])
    # a .pth-only directory classifies exactly as the msgpack one
    pth_dir = tmp_path / "pth_only"
    pth_dir.mkdir()
    for f in ("config.ini", "class_names.txt"):
        shutil.copy(d / f, pth_dir)
    shutil.copy(out, pth_dir / checkpoint.TORCH_STATE)
    x = torch.from_numpy(tf.images(3, seed=5)).permute(0, 3, 1, 2)
    a, b = logits(d, x), logits(pth_dir, x)
    assert float(a.std(0).max()) > 1e-3  # the inputs tell apart
    assert torch.equal(a, b)


def test_export_cli_default_path(tmp_path, capsys):
    d, _ = model_dir(tmp_path, "resnet18")
    main(["export", str(d)])
    default = d / checkpoint.TORCH_STATE
    assert f"Wrote {default}" in capsys.readouterr().out
    main(["export", str(d), "-o", str(tmp_path / "elsewhere.pth")])
    a = torch.load(default, weights_only=True)
    b = torch.load(tmp_path / "elsewhere.pth", weights_only=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # exporting a .pth-only directory reproduces its file
    (d / "best_state.msgpack").unlink()
    main(["export", str(d), "-o", str(tmp_path / "again.pth")])
    c = torch.load(tmp_path / "again.pth", weights_only=True)
    assert a.keys() == c.keys() and all(torch.equal(a[k], c[k]) for k in a)
