"""Continuous-batching serving example on the PyTorch/H100 port.

The counterpart of ``examples/serve_lm.py`` over ``repro_torch``, with
the same arguments: requests are submitted into the engine's admission
queue on a staggered schedule and the scheduler is pumped with
``step()`` — per-step slot refill, paged KV from the context BufferPool,
decode overlapping refill prefills on the event DAG (docs/serving.md).
The model is smollm-135m's reduced config; on a card it runs through the
hand-written ``rmsnorm`` and ``decode_attention`` kernels.  It runs on
the first CUDA device unless ``--device`` names another (``--device cpu``
runs the kernels' plain versions); with no card and no ``--device`` it
raises ``DeviceNotFoundError``.

  PYTHONPATH=src python examples/torch_serve_lm.py               # a card
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu  # CPU
"""

import argparse

from repro_torch.launch import serve as serve_cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the first "
                         "CUDA device); 'cpu' for tests")
    args = ap.parse_args(argv)
    argv = ["--arch", "smollm-135m", "--smoke", "--requests", "6",
            "--max-new", "12", "--batch-slots", "2", "--max-seq", "64",
            "--arrival-every", "2"]
    if args.device:
        argv += ["--device", args.device]
    return serve_cli.main(argv)


if __name__ == "__main__":
    main()
