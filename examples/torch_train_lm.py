"""End-to-end training driver example on the PyTorch/H100 port.

The counterpart of ``examples/train_lm.py`` over ``repro_torch``, with
the same arguments.  Default: trains the reduced smollm config for 150
steps on the synthetic pipeline, with checkpointing + resume (rerun with
the same ``--ckpt-dir`` and it resumes from the last checkpoint).
``--full`` trains the full SmolLM-135M config; on a card, for example:

  PYTHONPATH=src python examples/torch_train_lm.py --full --steps 300 \\
      --batch 32 --seq 1024

where the forward runs the hand-written ``flash_attention`` and
``rmsnorm`` kernels.  It runs on the first CUDA device unless
``--device`` names another (``--device cpu`` runs the kernels' plain
versions); with no card and no ``--device`` it raises
``DeviceNotFoundError``.  Checkpoints go under ``build/`` of the
repository unless ``--ckpt-dir`` says otherwise.  Any further argument
goes to ``repro_torch.launch.train`` as it is.

  PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""

import argparse
import os

from repro_torch.launch import train as train_cli

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "torch_train_lm_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="full 135M config instead of the smoke config")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args, extra = ap.parse_known_args(argv)

    argv = ["--arch", "smollm-135m", "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
            "--lr", "3e-3", "--log-every", "25"] + extra
    if not args.full:
        argv.append("--smoke")
    return train_cli.main(argv)


if __name__ == "__main__":
    main()
