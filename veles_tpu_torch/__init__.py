"""veles_tpu_torch — the PyTorch/CUDA port of veles_tpu, for NVIDIA Hopper.

The JAX package `veles_tpu` stays beside it as the reference; this
package imports nothing of it (nor JAX) and keeps its own copies of what
it needs. This slice serves the full-width AlexNet: plain tensor code is
PyTorch, and the TPU kernels on the forward path are CUDA C++ for
`sm_90a` (ops/kernels.py, csrc/). Entry points run on the card unless the
caller asks for the CPU.
"""

from veles_tpu_torch.config import root

__all__ = ["root"]
