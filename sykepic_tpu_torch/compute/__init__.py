"""Inference: the engine, the ``prob`` command and the fused pipeline."""
