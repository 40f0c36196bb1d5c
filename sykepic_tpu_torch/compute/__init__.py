"""Inference and post-processing: the engine, the ``prob``, ``feat`` and
fused ``pipeline`` commands, and the pandas CSV sub-commands (``class``,
``size``, ``abundance``, ``class_stats``, ``features_per_prediction``)."""
