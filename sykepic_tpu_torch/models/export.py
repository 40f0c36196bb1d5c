"""``export``: a model directory -> a reference-loadable ``best_state.pth``
(the port of ``sykepic_tpu/__main__.py::_export`` with
``sykepic_tpu/models/convert_torch.py::save_pth``).

The directory's checkpoint (``best_state.msgpack``, else its ``.pth``)
loads as a torchvision-named ``state_dict``
(:func:`~sykepic_tpu_torch.models.checkpoint.load_model_state`, head
Linears at their ``head.K`` indices by the ``[model] dropout`` spec, every
BatchNorm's ``num_batches_tracked`` 0 from a msgpack) and is renamed into
the reference ``base.N`` layout
(:func:`~sykepic_tpu_torch.models.checkpoint.reference_state_dict`), then
saved with ``torch.save``: the keys and tensors the JAX exporter writes for
the same directory.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..train import config as train_config
from . import checkpoint


def export(model_dir, out=None) -> Path:
    """Write ``model_dir``'s checkpoint to ``out`` (default
    ``<model_dir>/best_state.pth``); returns the path written."""
    model_dir = Path(model_dir)
    config = train_config.read_config(model_dir / "config.ini")
    _, dropout = train_config.get_head_spec(config)
    network = config.get("model", "network", fallback=None)
    if network and checkpoint.family(network) == "swin":
        # the JAX exporter has no Swin, and its best_state.pth is already
        # the reference's layout
        raise ValueError(f"export writes what the JAX exporter writes; "
                         f"{checkpoint.NO_FLAX}")
    state = checkpoint.load_model_state(model_dir, dropout, network=network)
    out = Path(out) if out else model_dir / checkpoint.TORCH_STATE
    torch.save(checkpoint.reference_state_dict(state, network), str(out))
    return out
