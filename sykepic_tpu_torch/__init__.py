"""sykepic-tpu-torch: the PyTorch/CUDA port of ``sykepic_tpu`` for NVIDIA
Hopper (H100, sm_90a).

It sits beside the JAX package and is held against it, module by module, on
the same inputs. It imports ``torch`` and never JAX or the JAX package; the
jax-free helpers it needs (IFCB ingest, packing, the wire codec, the native
host library) are its own copies.

Layout (the JAX package's layer map):

- :mod:`sykepic_tpu_torch.utils`   -- logging, file layout, stage timers
- :mod:`sykepic_tpu_torch.ingest`  -- IFCB raw decoding + ROI packing
  (:mod:`sykepic_tpu_torch.ingest.native` holds the C++ host helpers)
- :mod:`sykepic_tpu_torch.ops`     -- eval preprocessing (the hand-written
  resize/pad kernel in ``csrc/resize_pad.cu``), the on-device geometry
  features (the hand-written flood kernel in ``csrc/flood.cu``) and the wire
  decoder
- :mod:`sykepic_tpu_torch.models`  -- every model family, checkpoint
  loading and ``export`` (a reference-loadable ``best_state.pth``)
- :mod:`sykepic_tpu_torch.compute` -- the inference engine, ``prob``, the
  host features and ``feat`` (numpy and scipy), ``pipeline`` (host-thread
  features beside the device, or ``--device-features``), the ``watch``
  daemon and the pandas CSV sub-commands (``class``, ``size``,
  ``abundance``, ``class_stats``, ``features_per_prediction``)
- :mod:`sykepic_tpu_torch.analyze` -- ``evaluate``, ``frequency``, plots and
  the classification report
- :mod:`sykepic_tpu_torch.train`   -- ``train`` and its side modes
- :mod:`sykepic_tpu_torch.parallel` -- several cards (torch.distributed)
- :mod:`sykepic_tpu_torch.device`  -- device resolution (cuda by default)

Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
