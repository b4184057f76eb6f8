"""Hand-written CUDA kernels (sm_90a), one for each Pallas TPU kernel.

- gram_update:     fused border evaluation + both Gram products, canonical
  carried reduction (replaces Pallas ``gram_update_acc`` and ``gram_update``)
- ihb_update:      Theorem 4.9 block-inverse update, in place, and the fast
  engine's candidate loop of one degree in one launch (replaces Pallas
  ``ihb_update``)
- flash_attention: online-softmax GQA attention, causal or not, dv != d,
  bf16 on the tensor cores (replaces Pallas ``flash_attention``)

``ops`` holds the public wrappers (plain PyTorch on CPU tensors, the kernel
on CUDA tensors); ``ref`` holds the plain versions.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
