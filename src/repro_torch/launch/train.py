"""End-to-end training entry point on one card (or the CPU, for tests).

The port of ``repro.launch.train``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --device cpu --steps 30 --batch 8 --seq 64

trains the architecture's full published config with random weights
from ``--seed`` on the synthetic stream (``--smoke`` for the reduced
one), on the first CUDA device unless ``--device`` names another
(``--device cpu`` runs the kernels' plain versions); with no card and no
``--device`` it raises :class:`~repro_torch.runtime.DeviceNotFoundError`.
``--remat`` overrides the config's per-block checkpointing (none | block
| full | dots).  ``--mesh DATAxMODEL`` trains on a ("data", "model")
mesh of that shape over the live process group
(:func:`~repro_torch.launch.mesh.make_host_mesh`: every rank of a
``torchrun`` world, or a one-rank group it starts itself), its state
placed by the sharding rules as the reference builds them
(``BASELINE_RULES`` pruned to the mesh, then adapted to the model); the
default is the one-device trainer.  The loop is restart-safe: rerunning with the same
``--ckpt-dir`` resumes from the last checkpoint.  It prints and returns
the history, the host seconds of each step and the tokens per second.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Dict

from .. import configs
from ..data import data_iterator
from ..distributed.sharding import rules_for_model
from ..training import OptimizerConfig, TrainConfig, Trainer
from .mesh import make_host_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--remat", default=None,
                    choices=["none", "block", "full", "dots"],
                    help="per-block checkpointing (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the first "
                         "CUDA device); 'cpu' for tests")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train on a (data, model) mesh of this shape "
                         "(default: one device)")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if args.remat is not None:
        cfg = dataclasses.replace(cfg, remat=args.remat)

    tcfg = TrainConfig(
        num_microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every,
        opt=OptimizerConfig(lr=args.lr, warmup_steps=min(100, args.steps),
                            total_steps=args.steps))
    if args.mesh:
        data, model = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_host_mesh(model_axis=model, device=args.device)
        if mesh.size() != data * model:
            raise ValueError(f"--mesh {args.mesh}: the process group has "
                             f"{mesh.size()} ranks")
        trainer = Trainer(cfg, tcfg, mesh=mesh,
                          rules=rules_for_model(cfg, mesh))
    else:
        trainer = Trainer(cfg, tcfg, device=args.device)
    start = trainer.init(args.seed)
    where = f"mesh {args.mesh} ({trainer.device.type})" if args.mesh \
        else str(trainer.device)
    print(f"training {cfg.name} from step {start} on {where} "
          f"(batch={args.batch} seq={args.seq} remat={cfg.remat})")
    it = data_iterator(cfg, args.batch, args.seq, start_step=start,
                       seed=args.seed)
    t0 = time.perf_counter()
    hist = trainer.run(it, args.steps - start)
    dt = time.perf_counter() - t0
    it.close()
    steps_done = args.steps - start
    secs = trainer.step_seconds
    tokens = args.batch * args.seq
    med = statistics.median(secs) if secs else None
    print(f"{steps_done} steps in {dt:.1f}s "
          f"({steps_done / max(dt, 1e-9):.2f} steps/s)")
    if med:
        print(f"median step {med * 1e3:.1f} ms, "
              f"{tokens / med:.0f} tokens/s")
    for h in hist:
        print({k: round(v, 4) for k, v in h.items()})
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(hist, f, indent=1)
    return {"trainer": trainer, "history": hist, "step_seconds": secs,
            "step_median_s": med, "tokens_per_step": tokens,
            "tokens_per_s": tokens / med if med else None, "wall_s": dt,
            "device": str(trainer.device)}


if __name__ == "__main__":
    main()
