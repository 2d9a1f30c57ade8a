"""Host-side resource accounting copied from the reference (jax-free)."""
