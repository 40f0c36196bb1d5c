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
  resize/pad kernel in ``csrc/resize_pad.cu``) and the wire decoder
- :mod:`sykepic_tpu_torch.models`  -- ResNet family + checkpoint loading
- :mod:`sykepic_tpu_torch.compute` -- the inference engine and ``prob``
- :mod:`sykepic_tpu_torch.device`  -- device resolution (cuda by default)

Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
