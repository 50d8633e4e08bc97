"""Mesh construction and the H100's figures.

The port of ``repro.launch.mesh``.  Meshes are ``torch.distributed``
:class:`~torch.distributed.device_mesh.DeviceMesh`\\ es with named dims.

``make_production_mesh`` builds the 16x16 (``data`` x ``model``) or
2x16x16 (``pod`` x ``data`` x ``model``) production mesh.  Where the
world is not that large (always on one card or the CPU) it starts the
*fake* process group first (``torch.testing``'s ``FakeStore``, backend
``"fake"``): rank 0 of a world of 256 or 512, whose collectives return
at once and move nothing.  It owns no memory and runs no kernel, which
is the dry-run's point (:mod:`.dryrun`): a step traced there with fake
tensors prices one device of the production mesh.  It is a function,
not a constant, so importing this module starts no process group.

``make_host_mesh`` builds a (data, model) mesh over the live process
group (starting a one-rank group when there is none), on the card unless
the caller passes ``device="cpu"``.

``HW`` holds one NVIDIA H100 SXM's data-sheet figures at its 700 W
power limit; :func:`measure_hw` measures the card's own.
"""

from __future__ import annotations

import math
import os
import statistics
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..runtime import DeviceNotFoundError

#: one NVIDIA H100 SXM, data sheet (dense, no sparsity), at 700 W
HW = {
    "peak_flops_bf16": 989e12,       # FLOP/s, bf16 tensor cores
    "hbm_bw": 3.35e12,               # B/s, HBM3
    "link_bw": 900e9,                # B/s, NVLink 4 (18 links), per card
    "hbm_bytes": 80 * 1024**3,       # without a card; see hbm_bytes()
}


def hbm_bytes(device: Optional[torch.device] = None) -> int:
    """The card's memory (``torch.cuda.get_device_properties``), or the
    data sheet's 80 GiB where there is no card."""
    if device is not None and torch.device(device).type == "cuda" \
            or device is None and torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(
            device if device is not None else 0).total_memory)
    return HW["hbm_bytes"]


def fake_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` as rank 0 of the fake process group of that
    many ranks, started here if no process group is.  An existing group
    of the same size is used as it is; one of another size raises
    (destroy it first)."""
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"a {tuple(shape)} mesh needs a world of {n} ranks; the "
                f"live process group has {dist.get_world_size()} "
                f"(destroy it first)")
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """16x16 single-pod (256 cards) or 2x16x16 multi-pod, over the fake
    process group unless the world is that large."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes, device_type)


def make_host_mesh(model_axis: int = 1,
                   device: Optional[str] = None) -> DeviceMesh:
    """A (world / model_axis, model_axis) ``("data", "model")`` mesh over
    the live process group, on the card (``device=None`` or ``"cuda"``)
    or on the CPU (``device="cpu"``).  Without a process group it starts
    one (NCCL on the card, gloo on the CPU): over ``torchrun``'s ranks
    where its environment names them, else a one-rank group.  Without a card
    and without ``device="cpu"`` it raises
    :class:`~repro_torch.runtime.DeviceNotFoundError`."""
    dtype = "cuda" if device is None else torch.device(device).type
    if dtype == "cuda" and not torch.cuda.is_available():
        raise DeviceNotFoundError(
            "no CUDA device: the host mesh is on the card unless "
            "device='cpu' is given")
    if not dist.is_initialized():
        backend = "nccl" if dtype == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:      # torchrun's ranks
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"a world of {n} ranks does not split into "
                         f"model axes of {model_axis}")
    if dtype == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dtype, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def _cuda_ms(fn, reps: int) -> Tuple[float, ...]:
    """Each of ``reps`` calls of ``fn`` timed with CUDA events, in ms."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return tuple(out)


def measure_hw(device=None, n: int = 8192, reps: int = 20,
               copy_bytes: int = 4 * 1024**3) -> Dict[str, float]:
    """The card's own figures beside :data:`HW`: bf16 ``torch.matmul`` at
    n x n x n (the median of ``reps``, after a warm-up), a device-to-
    device copy of ``copy_bytes`` (counted as read plus written), and
    its memory.  A measurement of the card: without one it raises
    :class:`~repro_torch.runtime.DeviceNotFoundError`."""
    if not torch.cuda.is_available():
        raise DeviceNotFoundError("measure_hw measures a CUDA device")
    dev = torch.device(device if device is not None else "cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev, dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=dev, dtype=torch.bfloat16)
    torch.matmul(a, b)
    mm = statistics.median(_cuda_ms(lambda: torch.matmul(a, b), reps))
    del a, b
    src = torch.empty(copy_bytes, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    cp = statistics.median(_cuda_ms(lambda: dst.copy_(src), 5))
    del src, dst
    torch.cuda.empty_cache()
    return {"matmul_ms": mm, "peak_flops_bf16": 2.0 * n ** 3 / (mm * 1e-3),
            "copy_ms": cp, "hbm_bw": 2.0 * copy_bytes / (cp * 1e-3),
            "hbm_bytes": float(hbm_bytes(dev))}


__all__ = ["HW", "fake_mesh", "hbm_bytes", "make_host_mesh",
           "make_production_mesh", "measure_hw"]
