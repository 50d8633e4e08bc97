"""Loading the model kernels' CUDA sources (``csrc/*.cu``) with ``ctypes``.

Each kernel is one source file with a plain C launcher that returns
``cudaGetLastError()`` after the launch.  :class:`CudaKernel` builds it
with ``nvcc`` into ``build/repro_torch/`` at first use (named by the
SHA-256 of its source and flags, :mod:`repro_torch.core.nvcc`), loads it,
and counts the launches its wrapper makes.  Nothing is built or loaded
when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from typing import Callable, Sequence

import torch

from ..core.errors import InvalidArgError
from ..core.nvcc import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, NvccJob, \
    build_parallel
from ..core.targets.cuda_target import LaunchError

#: dtype codes the C launchers take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class CudaKernel:
    """One hand-written CUDA kernel: its source, its library and its
    launch count.

    ``launches`` is a plain integer; the wrapper adds one for each launch
    it makes (:meth:`launch`), and nothing else touches it but a caller
    resetting it."""

    def __init__(self, name: str, source: str, launcher: str,
                 argtypes: Sequence[object]):
        self.name = name
        self.source_path = CSRC_DIR / source
        self.launcher = launcher
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def digest(self) -> str:
        h = hashlib.sha256(self.source_path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()

    @property
    def lib_path(self):
        return BUILD_DIR / f"{self.name}_{self.digest[:40]}.so"

    def nvcc_job(self) -> NvccJob:
        """The build of this kernel's library (for a parallel wave)."""
        return NvccJob(self.name, self.source_path.read_text(),
                       self.lib_path)

    def _load(self) -> Callable[..., int]:
        with self._lock:
            if self._fn is None:
                path = self.lib_path
                if not path.exists():
                    build_parallel([self.nvcc_job()])
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, self.launcher)
                fn.restype = ctypes.c_int
                fn.argtypes = self.argtypes
                err = lib.kernel_error_string
                err.restype = ctypes.c_char_p
                err.argtypes = [ctypes.c_int]
                self._lib, self._fn, self._err = lib, fn, err
            return self._fn

    def function(self, name: str, restype, argtypes: Sequence[object]):
        """Another C function of the kernel's library (built and loaded
        as for :meth:`launch`), such as one that reports a launch's
        plan.  Calling it adds nothing to ``launches``."""
        self._load()
        fn = getattr(self._lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        return fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the C launcher with ``args`` and the current stream of
        ``device``; raise :class:`LaunchError` if it reports an error."""
        fn = self._load()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise LaunchError(f"{self.name} launch failed: "
                              f"{self._err(rc).decode()} (cudaError {rc})")
        with self._lock:
            self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, device: torch.device,
                      dtypes, shape=None) -> None:
    """The checks a wrapper makes before it launches: device, dtype,
    shape and contiguity.  Raises
    :class:`~repro_torch.core.errors.InvalidArgError`."""
    if t.device != device:
        raise InvalidArgError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise InvalidArgError(
            f"{name} has dtype {t.dtype}; the kernel takes "
            f"{sorted(str(d) for d in dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise InvalidArgError(f"{name} has shape {tuple(t.shape)}, "
                              f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise InvalidArgError(f"{name} is not contiguous")


def refuse_grad(name: str, tensors, why: str) -> None:
    """Raise ``NotImplementedError`` when autograd would record a call of
    a kernel that has no backward: grad mode is on and an input requires
    grad.  The wrapper's output would otherwise come back with no
    ``grad_fn`` and the gradient would stop there without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no backward: {why}")


__all__ = ["CudaKernel", "DTYPE_CODES", "check_cuda_tensor", "refuse_grad"]
