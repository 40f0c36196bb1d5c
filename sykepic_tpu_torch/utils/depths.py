"""Async-pipeline depths, defined ONCE.

Both the engine's in-flight dispatch queues (compute/engine.py) and the
shelf window-buffer pool capacity (ingest/shelf.py) derive from these, so
the recycling pool always holds every buffer in flight.

The values are the JAX package's, which tuned them for a TPU behind a slow
link; whether they suit the card is an open question in PERF.md.
"""

PIPELINE_DEPTH = 12
FUSED_PIPELINE_DEPTH = 8
