"""Performance-portability scoreboard on one card, or the CPU for tests
(paper §4, Figs. 12-14; Rupp et al.).

The port's counterpart of ``benchmarks/bench_scoreboard.py``.  Runs the
suite kernels through :class:`~repro_torch.suite.scoreboard.Scoreboard`
— a tuning-space sweep per (kernel, target) cell with bitwise oracle
checks and a roofline against peaks calibrated on the device — and
writes the matrix as JSON and as a markdown table, by default under
``build/repro_torch/``.  The device is the first CUDA device unless
``--device`` names another (``--device cpu`` runs the torch targets on
the CPU); with no card and no ``--device`` it raises
:class:`~repro_torch.runtime.DeviceNotFoundError`.

Exit status is the gate verdict:

  (a) every cell bitwise-equal to its NumPy oracle,
  (b) every swept cell's autotuned config at the minimum of its sweep,
  (c) every kernel's achieved-vs-roofline fraction on the vector target
      >= --min-fraction (env REPRO_SCOREBOARD_MIN_FRACTION).

  PYTHONPATH=src python -m repro_torch.launch.scoreboard --ci --device cpu
  PYTHONPATH=src python -m repro_torch.launch.scoreboard --shape-set card
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..core.autotune import TuningTable
from ..core.nvcc import BUILD_DIR
from ..runtime import Context, Platform
from ..suite.scoreboard import Scoreboard, check_gates, render_markdown

DEFAULT_MIN_FRACTION = float(
    os.environ.get("REPRO_SCOREBOARD_MIN_FRACTION", "0.0005"))


def run(ci: bool = False, shape_set: str | None = None,
        table_path: str | None = None,
        min_fraction: float = DEFAULT_MIN_FRACTION, kernels=None,
        device: str | None = None):
    """One scoreboard over the suite: ``ci`` is the reduced sweep (the
    ``ci`` shapes unless ``shape_set`` names others, two configurations
    a space); returns the report with its gates."""
    ctx = Context(platform=Platform(torch_device=device))
    table = TuningTable(table_path) if table_path else TuningTable()
    sb = Scoreboard(
        ctx=ctx, table=table,
        shape_set=shape_set or ("ci" if ci else "full"),
        warmup=1,
        repeats=2 if ci else 3,
        max_configs=2 if ci else None,
        calibration_n=1 << 12 if ci else 1 << 14,
    )
    report = sb.run(kernels=kernels)
    report["gates"] = check_gates(report, min_fraction=min_fraction,
                                  fraction_target="vector")
    return report


def summary_lines(report) -> list:
    """The peaks beside the data sheet's, and each cell's times and
    fractions, one line each."""
    lines = []
    sheet = report.get("datasheet")
    for t, p in report["peaks"].items():
        line = f"peaks {t}: {p['gflops']:.2f} GFLOP/s, {p['gbs']:.2f} GB/s"
        if sheet:
            line += (f" (data sheet {sheet['gflops']:.0f} GFLOP/s, "
                     f"{sheet['gbs']:.0f} GB/s)")
        lines.append(line)
    for name, ent in report["kernels"].items():
        for tgt, cell in ent["cells"].items():
            line = (f"{name}/{tgt} `{cell['config']}`: "
                    f"{cell['time_us']:.1f} us, fraction "
                    f"{cell['roofline']['fraction']:.4f}")
            if "wall_us" in cell:
                line += (f", wall {cell['wall_us']:.1f} us, data-sheet "
                         f"fraction {cell['fraction_datasheet']:.4f}")
            lines.append(line)
    for why in report.get("absent", {}).items():
        lines.append("absent %s: %s" % why)
    for item in report.get("above_roofline", []):
        lines.append(f"FRACTION ABOVE 1: {item}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ci", action="store_true",
                    help="reduced sweep: ci shapes, 2 configs per space")
    ap.add_argument("--shape-set", choices=["ci", "full", "card"],
                    default=None,
                    help="problem sizes (default: ci with --ci, else full)")
    ap.add_argument("--out", default=str(BUILD_DIR / "scoreboard.json"))
    ap.add_argument("--md", default=str(BUILD_DIR / "scoreboard.md"))
    ap.add_argument("--table", default=None,
                    help="TuningTable path for persisted sweep winners "
                         "(a warm run re-measures only the winner)")
    ap.add_argument("--min-fraction", type=float,
                    default=DEFAULT_MIN_FRACTION,
                    help="achieved-vs-roofline floor on the vector target")
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="subset of suite kernels (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device); "
                         "'cpu' for tests")
    args = ap.parse_args(argv)

    report = run(ci=args.ci, shape_set=args.shape_set,
                 table_path=args.table, min_fraction=args.min_fraction,
                 kernels=args.kernels, device=args.device)

    for path in (args.out, args.md):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    md = render_markdown(report)
    with open(args.md, "w") as f:
        f.write(md)
    print(md)
    print("\n".join(summary_lines(report)))
    print(f"matrix -> {args.out}\ntable  -> {args.md}")

    gates = report["gates"]
    for k in ("bitwise_failures", "winner_failures", "fraction_failures"):
        for item in gates[k]:
            print(f"GATE FAIL [{k}]: {item}")
    status = "OK" if gates["ok"] else "BELOW TARGET"
    print(f"scoreboard gates (bitwise + winner<=worst + "
          f"fraction>={gates['min_fraction']}): {status}")
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["gates"]["ok"] else 1)
