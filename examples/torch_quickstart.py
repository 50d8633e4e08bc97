"""Quickstart on the PyTorch/H100 port: the pocl kernel compiler in 60
seconds.

The counterpart of ``examples/quickstart.py`` over ``repro_torch``.  It
authors the paper's Fig. 1 vector dot-product kernel in the SPMD DSL,
builds it through the host object model — Context -> Program -> Kernel
(docs/host_api.md) — for the ``loop`` and ``vector`` mappings and, on a
card, the hand-written ``cuda`` work-group target (one thread block a
work-group), and validates each against the fiber-semantics oracle.
It runs on the first CUDA device unless ``--device`` names another; with
no card and no ``--device`` it raises ``DeviceNotFoundError``.

  PYTHONPATH=src python examples/torch_quickstart.py               # a card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # CPU
"""

import argparse

import numpy as np

from repro_torch.core import KernelBuilder
# sanctioned oracle use: this example demonstrates validating against the
# fiber reference executor (see ruff.toml banned-api)
from repro_torch.core import run_ndrange  # noqa: TID251
from repro_torch.runtime import Context, Platform


def build_dot_product():
    """__kernel void dot(__global float4 *a, b, c)  (paper Fig. 1)."""
    b = KernelBuilder("dot_product")
    a_ = b.arg_buffer("a", "float32")
    b_ = b.arg_buffer("b", "float32")
    c_ = b.arg_buffer("c", "float32")
    gid = b.global_id(0)
    # float4 dot product: each work-item reduces 4 adjacent lanes
    acc = b.var(0.0, name="acc")
    i = b.var(b.const(0), name="i")
    with b.while_loop() as loop:
        loop.cond(i.get() < 4)
        acc.set(acc.get() + a_[gid * 4 + i.get()] * b_[gid * 4 + i.get()])
        i.set(i.get() + 1)
    c_[gid] = acc.get()
    return b.finish()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the first CUDA "
                         "device); 'cpu' runs the loop and vector targets")
    args = ap.parse_args(argv)

    n = 256
    rng = np.random.default_rng(0)
    a = rng.standard_normal(n * 4).astype(np.float32)
    b = rng.standard_normal(n * 4).astype(np.float32)

    # 1. semantics oracle: fiber execution (Clover/Twin-Peaks style)
    ref = run_ndrange(build_dot_product(), (n,), (64,),
                      {"a": a.copy(), "b": b.copy(),
                       "c": np.zeros(n, np.float32)})

    # 2. the host object model: one Program, one Kernel with
    #    clSetKernelArg-style bound arguments; the pocl pipeline
    #    specializes lazily per (device, local_size, target)
    ctx = Context(platform=Platform(torch_device=args.device))
    prog = ctx.create_program(build_dot_product).build()
    print(f"program kernels={prog.kernel_names()}")
    kernel = prog.create_kernel("dot_product")
    kernel.set_args(a=a, b=b, c=np.zeros(n, np.float32))

    device = ctx.devices[0]
    targets = ["loop", "vector"]
    if device.torch_device.type == "cuda":
        targets.append("cuda")
    for target in targets:
        out = ctx.launch(kernel, (n,), (64,), target=target)
        np.testing.assert_allclose(out["c"].cpu().numpy(), ref["c"],
                                   rtol=1e-5, atol=2e-6)
        binary = kernel.bind(device, (64,), target=target)
        print(f"target={target:7s} regions={binary.num_regions} "
              f"context={binary.context_stats} OK")

    expect = (a.reshape(-1, 4) * b.reshape(-1, 4)).sum(1)
    np.testing.assert_allclose(ref["c"], expect, rtol=1e-5, atol=2e-6)
    print("dot product matches numpy; all targets agree with the oracle")


if __name__ == "__main__":
    main()
