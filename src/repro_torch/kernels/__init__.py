"""repro_torch.kernels — the model kernels, written by hand in CUDA C++
for Hopper (``csrc/rmsnorm.cu``, ``csrc/decode_attention.cu``), each with
its plain PyTorch version beside it, the torch references (:mod:`.ref`)
and the ``use_kernels`` dispatch (:mod:`.ops`).  Nothing is built when the
package is imported: a kernel builds with ``nvcc`` at its first launch."""

from . import decode_attention, ops, ref, rmsnorm

#: every CUDA kernel of the package, for a parallel build and for
#: reading and resetting the launch counts
KERNELS = (rmsnorm.KERNEL, decode_attention.KERNEL)

__all__ = ["KERNELS", "decode_attention", "ops", "ref", "rmsnorm"]
