"""PyTorch/CUDA port of the JAX package ``repro``.

Mirrors ``repro``'s subpackage names. It imports ``torch`` and never
``jax`` or anything of ``repro``; the tests hold each ported part
against the JAX package by feeding both the same numpy inputs.
"""
