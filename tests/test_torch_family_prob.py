"""Model directories of the other families through both packages'
``prob``, on the CPU: ``efficientnet_b0`` and ``convnext_tiny`` directories
at 3x64x64 written by the JAX package (its own init, with random BatchNorm
running statistics and a ConvNeXt ``layer_scale`` of order 0.1, so that
the blocks count). The port's ``prob --device cpu`` against the JAX
package's ``prob`` on the fixture sample: the same files, ids and argmax,
values within 1.2e-5 (one 1e-5 quantum, as
``tests/test_torch_probability.py``). The reverse direction, a directory
the port trains read by the JAX package, is in
``tests/test_torch_convnext.py``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probability import QUANTUM_BOUND, RAW, _csvs, _read

from sykepic_tpu.__main__ import main as jax_main
from sykepic_tpu.models import checkpoint as jax_checkpoint
from sykepic_tpu.models import registry as jregistry
from sykepic_tpu_torch.__main__ import main
from sykepic_tpu_torch.models import checkpoint

SRC = "tests/model/resnet18_ref"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_model_dir(root, name):
    d = root / name
    d.mkdir()
    shutil.copy(f"{SRC}/class_names.txt", d)
    text = open(f"{SRC}/config.ini").read()
    for a, b in (("network = resnet18", f"network = {name}"),
                 ("shape = 3, 180, 180", "shape = 3, 64, 64"),
                 ("head = 256, 128", "head = 32, 16"),
                 ("dropout =\n", "dropout = -1, 0.5\n")):
        assert a in text
        text = text.replace(a, b)
    (d / "config.ini").write_text(text)
    n = len(checkpoint.read_class_names(d))
    model = jregistry.build_model(name, n, head=(32, 16),
                                  dropout=((-1, 0.5),))
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    variables = jax.tree_util.tree_map(np.asarray, dict(init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))))
    rng = np.random.default_rng(0)

    def move(path, a):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] == "mean":
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if keys[-1] == "var":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if keys[-1] == "layer_scale":
            return rng.uniform(0.05, 0.15, a.shape).astype(np.float32)
        return a

    variables = jax.tree_util.tree_map_with_path(move, variables)
    jax_checkpoint.save_variables(d / "best_state.msgpack", variables)
    return d


@pytest.mark.parametrize("name", ["efficientnet_b0", "convnext_tiny"])
def test_prob_on_a_jax_written_dir_matches_jax(tmp_path, name):
    model_dir = _jax_model_dir(tmp_path, name)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    main(["prob", "-r", RAW, "-m", str(model_dir), "-o", str(mine), "-b",
          "4", "--device", "cpu"])
    jax_main(["prob", "-r", RAW, "-m", str(model_dir), "-o", str(theirs),
              "-b", "4"])
    got, want = _csvs(mine), _csvs(theirs)
    assert list(got) == list(want) and len(got) == 1
    for rel in got:
        gh, gr = _read(got[rel])
        wh, wr = _read(want[rel])
        assert gh == wh and gh.startswith("roi,")
        np.testing.assert_array_equal(gr[:, 0], wr[:, 0])
        assert np.abs(gr[:, 1:] - wr[:, 1:]).max() <= QUANTUM_BOUND
        np.testing.assert_array_equal(gr[:, 1:].argmax(1),
                                      wr[:, 1:].argmax(1))
        assert wr[:, 1:].max() < 0.9  # not saturated: the values say much
