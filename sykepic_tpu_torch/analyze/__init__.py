"""Analysis helpers the port's training reaches (the port of
``sykepic_tpu/analyze``): the training-curve plot and the classification
report."""
