"""Building CUDA sources with ``nvcc`` into ``ctypes``-loadable libraries.

Shared by the ``cuda`` work-group target
(:mod:`repro_torch.core.targets.cuda_target`) and the model kernels
(:mod:`repro_torch.kernels`).  Every source becomes one shared library
with a plain C interface, built for Hopper (``sm_90a``) into
``build/repro_torch/`` and named by a digest of its source, headers and
flags, so an unchanged kernel is never rebuilt.  :func:`build_parallel`
starts one ``nvcc`` per source, all at once, and waits for them all.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

from .errors import BuildError

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-w")


@dataclass(frozen=True)
class NvccJob:
    """One library to build: ``source`` (CUDA C++ text) compiled with
    :data:`NVCC_FLAGS` and ``-I csrc`` into ``out``.  The source is
    written beside the library as ``out`` with a ``.cu`` suffix.
    ``label`` names the job in error messages."""

    label: str
    source: str
    out: Path


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin, "
                     "/usr/local/cuda/bin); the CUDA kernels are built on "
                     "the machine with the card")


def build_parallel(jobs: Iterable[NvccJob]) -> Dict[Path, float]:
    """Build every job whose library does not exist yet: one ``nvcc`` per
    job, all started together.  Returns the wall-clock build seconds by
    library path; raises :class:`~repro_torch.core.errors.BuildError`
    with the compiler's output if any build fails."""
    pending: Dict[Path, NvccJob] = {}
    for j in jobs:
        if not Path(j.out).exists():
            pending.setdefault(Path(j.out), j)
    if not pending:
        return {}
    nvcc = find_nvcc()
    running = []
    try:
        for out, j in pending.items():
            out.parent.mkdir(parents=True, exist_ok=True)
            cu = out.with_suffix(".cu")
            cu.write_text(j.source)
            tmp = Path(tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")[1])
            log = open(tmp.with_suffix(".log"), "w+")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(cu)]
            running.append([out, tmp, log, time.perf_counter(),
                            subprocess.Popen(cmd, stdout=log,
                                             stderr=subprocess.STDOUT), None])
        while any(r[5] is None for r in running):
            for r in running:
                if r[5] is None and r[4].poll() is not None:
                    r[5] = time.perf_counter() - r[3]
            time.sleep(0.02)
    finally:
        for r in running:
            if r[4].poll() is None:
                r[4].kill()
                r[4].wait()
    times, errors = {}, []
    for out, tmp, log, _, proc, secs in running:
        log.seek(0)
        text = log.read()
        log.close()
        os.remove(log.name)
        if proc.returncode != 0:
            errors.append(f"--- {pending[out].label} ({out.name}): "
                          f"nvcc exit {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        times[out] = secs
    if errors:
        log = "\n".join(errors)
        raise BuildError(f"{len(errors)} cuda kernel build(s) failed:\n"
                         f"{log[:4000]}", build_log=log)
    return times


__all__ = ["NvccJob", "build_parallel", "find_nvcc", "BUILD_DIR", "CSRC_DIR",
           "NVCC_FLAGS"]
