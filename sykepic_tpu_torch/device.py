"""Device resolution for the port's entry points.

The rule: ``cuda`` unless the caller asks for ``cpu``. Asking for ``cuda``
on a host without a card raises; nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``; raises ``RuntimeError`` for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on "
                "the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {dev}")
    return dev
