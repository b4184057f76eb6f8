"""PyTorch/CUDA port of the vanishing-ideal package ``repro``.

The same algorithms as the JAX package, in PyTorch, with the Pallas TPU
kernels rewritten by hand in CUDA C++ for Hopper (``kernels/csrc/``).  Entry
points take ``device=None``, which means the CUDA card; without a card they
raise unless the caller passes ``device="cpu"``.  Nothing here imports JAX or
the JAX package.
"""
