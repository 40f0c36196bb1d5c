"""Async-pipeline depth knobs, defined ONCE.

Both the engine's in-flight dispatch queues (compute/engine.py) and the
shelf window-buffer pool capacity (ingest/shelf.py) derive from these;
a single source keeps an env override of either depth from silently
overflowing the recycling pool back onto the page-fault path.

The defaults are the JAX package's, which tuned them for a TPU behind a
slow link; whether they suit the card is an open question in PERF.md.
"""

import os

PIPELINE_DEPTH = int(os.environ.get("SYKEPIC_PIPELINE_DEPTH", "12"))
FUSED_PIPELINE_DEPTH = int(os.environ.get("SYKEPIC_FUSED_PIPELINE_DEPTH", "8"))
