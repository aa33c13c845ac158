"""PyTorch/CUDA port of the PTQ1.61 quantize-then-serve system.

Mirrors the module layout of the JAX package ``repro`` (``configs``,
``core``, ``kernels``, ``models``, ``runtime``, ``launch``) so each module
has an obvious counterpart, but imports only ``torch`` and ``numpy``.
"""
