"""PyTorch / CUDA port of the serving stack (see README.md).

The JAX package ``repro`` is the reference; this package imports nothing
of it and no jax.  Entry points run on the card unless the caller asks
for the CPU.
"""
