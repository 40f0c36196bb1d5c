"""Analysis layer (the port of ``sykepic_tpu/analyze``): threshold
evaluation (``evaluate``), class-frequency time series (``frequency``),
plotting and the classification report."""
