"""Core: arbitrary-bit-width quantization + FINN-style graph compilation.

Layering (bottom to top), as in the JAX package:

quant  →  graph (IR + interpreter)  →  transforms (rewrites)  →
passes (PassManager + registry)  →  recipes (per-arch orderings)  →
datatypes (integer lowering)  →  deploy (``compile`` → ``DeployedModel``)

Submodules are imported where used; this package imports none eagerly.
"""
