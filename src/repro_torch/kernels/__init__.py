"""Hand-written CUDA kernels (sm_90a) for the OAVI hot path.

- gram_update: fused border evaluation + both Gram products, canonical
  carried reduction (replaces Pallas ``gram_update_acc`` and ``gram_update``)
- ihb_update:  Theorem 4.9 block-inverse update (replaces Pallas
  ``ihb_update``)

``ops`` holds the public wrappers (plain PyTorch on CPU tensors, the kernel
on CUDA tensors); ``ref`` holds the plain versions.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
