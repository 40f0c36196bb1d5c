"""Model directories of any network, written by the port alone (no JAX, so
the card's tests can use them): the repo's config
(``tests/model/resnet18_ref``) with the network, image size and head
replaced, the port's seeded init, random BatchNorm running statistics, and
the last head layer scaled so that the logits of random images spread with
a standard deviation of 8, as in ``chip_smoke.py::build_family_dir`` (at
the init's scale the probabilities sit near uniform and an argmax check
near empty)."""

import shutil
from pathlib import Path

import torch
from torch import nn

from sykepic_tpu_torch.models import checkpoint, registry
from sykepic_tpu_torch.train import config as tcfg

SRC = Path(__file__).parent / "model" / "resnet18_ref"


def family_model_dir(root, name: str, size: int = 180,
                     head=(256, 128)) -> Path:
    d = Path(root) / f"{name}_{size}"
    if d.exists():
        return d
    d.mkdir(parents=True)
    shutil.copy(SRC / "class_names.txt", d)
    text = (SRC / "config.ini").read_text()
    for a, b in (("network = resnet18", f"network = {name}"),
                 ("shape = 3, 180, 180", f"shape = 3, {size}, {size}"),
                 ("head = 256, 128", "head = " + ", ".join(map(str, head)))):
        assert a in text
        text = text.replace(a, b)
    (d / "config.ini").write_text(text)
    model, _ = tcfg.get_network(tcfg.read_config(d / "config.ini"),
                                len(checkpoint.read_class_names(d)))
    registry.init_weights(model, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=g) * 0.05)
                m.running_var.copy_(0.75 + 0.5 * torch.rand(
                    m.num_features, generator=g))
        logits = model.eval()(torch.rand(8, 3, size, size, generator=g))
        model.head[-1].weight.mul_(8.0 / float(logits.std()))
    checkpoint.save_variables(d / checkpoint.BEST_STATE,
                              checkpoint.to_flax_variables(
                                  model.state_dict(), name))
    return d
