"""PyTorch + CUDA port of rangeclip_tpu.

The JAX package ``rangeclip_tpu`` is the reference; this package imports
nothing from it, nor jax, flax, pandas or PIL at module scope.
"""
