"""Layers and hand-written kernels."""
