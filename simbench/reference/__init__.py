"""Plain references the benchmark holds the timed path's outputs against.

They import neither ``jax`` nor the JAX package nor anything of
``repro_torch``, and take only the inputs the benchmark made.
"""
