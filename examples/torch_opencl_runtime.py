"""The pocl host-runtime path (paper §2/§3) on the PyTorch/H100 port.

The counterpart of ``examples/opencl_runtime.py`` over ``repro_torch``:
context creation, program build, a typed buffer in device memory, kernel
argument binding, an out-of-order event queue, event profiling, and one
NDRange co-executed across two devices with the *same* Kernel object as
the single-device launch.  On a card the buffer lives in the card's
memory and the kernels run on the ``cuda`` work-group target.  It runs on
the first CUDA device unless ``--device`` names another; with no card and
no ``--device`` it raises ``DeviceNotFoundError``.

  PYTHONPATH=src python examples/torch_opencl_runtime.py               # a card
  PYTHONPATH=src python examples/torch_opencl_runtime.py --device cpu  # CPU
"""

import argparse

import numpy as np

from repro_torch.core import KernelBuilder
from repro_torch.runtime import Context, Platform


def build_scale():
    b = KernelBuilder("scale")
    x = b.arg_buffer("x", "float32")
    s = b.arg_scalar("s", "float32")
    g = b.global_id(0)
    x[g] = x[g] * s
    return b.finish()


def build_offset():
    b = KernelBuilder("offset")
    x = b.arg_buffer("x", "float32")
    o = b.arg_scalar("o", "float32")
    g = b.global_id(0)
    x[g] = x[g] + o
    return b.finish()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the first CUDA "
                         "device); 'cpu' for tests")
    args = ap.parse_args(argv)

    ctx = Context(platform=Platform(torch_device=args.device))
    print("context devices:")
    for d in ctx.devices:
        print(f"  {d.info.name}: driver={d.info.driver} "
              f"global_mem={d.query('global_mem_size') >> 20}MiB "
              f"max_wg={d.query('max_work_group_size')}")

    # one program holding both kernels (clBuildProgram builds them
    # together; specialization per local size stays lazy, paper §4.1)
    prog = ctx.create_program(build_scale, build_offset).build()
    scale = prog.create_kernel("scale")
    offset = prog.create_kernel("offset")

    n = 256
    host = np.arange(n, dtype=np.float32)
    out = np.zeros(n, np.float32)
    buf = ctx.create_buffer(n, "float32")              # clCreateBuffer

    # clSetKernelArg: bind the device buffer + scalars once; the same
    # kernel objects are enqueued below and (for scale) co-executed
    scale.set_args(x=buf, s=2.0)
    offset.set_args(x=buf, o=1.0)

    # event-ordered pipeline on an out-of-order queue:
    # write -> scale -> offset -> read
    q = ctx.create_queue(out_of_order=True)
    e_w = q.enqueue_write_buffer(buf, host)
    e_s = q.enqueue_nd_range(scale, (n,), (64,), wait_for=[e_w])
    e_o = q.enqueue_nd_range(offset, (n,), (64,), wait_for=[e_s])
    e_r = q.enqueue_read_buffer(buf, out, wait_for=[e_o])
    q.finish()

    np.testing.assert_allclose(out, host * 2.0 + 1.0)
    print(f"pipeline OK: buffer at chunk offset {buf.chunk.start}, "
          f"result[:4]={out[:4].tolist()}")
    print(f"buffer on {buf.data.device}, {q.stats['launches']} launches on "
          f"{q.device.info.name}")

    # event profiling: the clGetEventProfilingInfo counters
    print("event profile (us relative to first enqueue):")
    t0 = e_w.queued_ns
    for ev in (e_w, e_s, e_o, e_r):
        p = ev.profile
        print(f"  {ev.name:14s} queued={(p['queued_ns'] - t0) / 1e3:8.1f} "
              f"submit={(p['submit_ns'] - t0) / 1e3:8.1f} "
              f"start={(p['start_ns'] - t0) / 1e3:8.1f} "
              f"end={(p['end_ns'] - t0) / 1e3:8.1f}")
    buf.release()

    # multi-device co-execution: the SAME Kernel object (cloned so the
    # host-array binding never races the queue path), split across two
    # devices — bitwise identical to the single-device result
    k_host = scale.clone().set_arg("x", host.copy())
    single = ctx.launch(k_host, (n,), (64,))["x"].cpu().numpy()
    co = ctx.create_co_executor(ctx.platform.co_devices(2))
    merged = co.launch(k_host.clone(), (n,), (64,), mode="static")
    assert merged["x"].numpy().tobytes() == single.tobytes()
    st = co.last_stats
    print(f"co-execution OK: groups per device "
          f"{dict(sorted(st.groups_per_device.items()))}, "
          f"{st.migrations} buffer migrations")
    co.finish()


if __name__ == "__main__":
    main()
