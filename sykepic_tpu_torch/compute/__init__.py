"""Inference: the engine and the ``prob`` command."""
