#!/usr/bin/env python3
"""Time the ``cuda`` work-group target's real-size kernels on several trees.

Two steps.  In a git checkout, ``prepare`` unpacks the trees to compare
under ``OUT`` (a directory that ``.gitignore`` lists, such as ``build/``):

* ``OUT/parent``: ``git archive REV`` of the commit to compare against;
* ``OUT/change``: ``git archive $(git write-tree)``, the index as it
  stands (run ``git add -A`` first to take the working tree);
* ``OUT/no_ranges``: ``OUT/change`` with the mapping's index bounds
  (``cuda_mapping.int_ranges``) replaced by none, so every int32 add,
  subtract and multiply wraps and every LOCAL access is clamped, as
  before that decision: the mapping's direct region flow and kept
  barriers alone.

On a machine with one card, ``run`` then runs ``python3 chip_smoke.py``
from each named tree in the order given (for example ``parent no_ranges
change change no_ranges parent``, so that drift in the card's clocks
shows), writes each run's whole output to ``LOGS/<i>-<tree>.log`` and
prints a table of the phase-5 kernels: ms, threads per block, the
``__syncthreads()`` kept in the source, direct region flow, static SASS
counts.  It exits non-zero if any run fails.

  python3 tools/cuda_target_ab.py prepare build/ab HEAD
  python3 tools/cuda_target_ab.py run build/ab --logs build/ab/logs \\
      parent no_ranges change change no_ranges parent
"""

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tarfile

RANGES = "ranges=int_ranges(fn, lsz)"
MAPPING = os.path.join("src", "repro_torch", "core", "targets",
                       "cuda_mapping.py")


def unpack(rev: str, out: str) -> None:
    data = subprocess.run(["git", "archive", rev], check=True,
                          capture_output=True).stdout
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
        tar.extractall(out, filter="data")


def prepare(out: str, parent: str) -> None:
    tree = subprocess.run(["git", "write-tree"], check=True,
                          capture_output=True, text=True).stdout.strip()
    unpack(parent, os.path.join(out, "parent"))
    unpack(tree, os.path.join(out, "change"))
    nr = os.path.join(out, "no_ranges")
    shutil.rmtree(nr, ignore_errors=True)
    shutil.copytree(os.path.join(out, "change"), nr)
    path = os.path.join(nr, MAPPING)
    with open(path) as f:
        src = f.read()
    if src.count(RANGES) != 1:
        raise SystemExit(f"{path}: expected one {RANGES!r}")
    with open(path, "w") as f:
        f.write(src.replace(RANGES, "ranges={}"))
    print(f"parent {parent}, change {tree}, no_ranges under {out}")


def run(out: str, logs: str, trees) -> int:
    os.makedirs(logs, exist_ok=True)
    failed = 0
    for i, name in enumerate(trees):
        r = subprocess.run([sys.executable, "chip_smoke.py"],
                           cwd=os.path.join(out, name), capture_output=True,
                           text=True, timeout=1500)
        with open(os.path.join(logs, f"{i}-{name}.log"), "w") as f:
            f.write(r.stdout + "\n--- stderr\n" + r.stderr)
        failed += r.returncode != 0
        print(f"== {i} {name} rc={r.returncode}")
        for ln in r.stdout.splitlines():
            if not ln.startswith("{"):
                continue
            d = json.loads(ln)
            if d.get("phase") == 5:
                print(f"{d['kernel']:32s} {d['ms']:.4f} ms  "
                      f"threads {d.get('threads_per_block')}  "
                      f"barriers {d.get('barriers')}  "
                      f"direct {d.get('direct')}  sass {d.get('sass')}")
        # the card's name and power limit, then the result line
        print("\n".join(r.stdout.splitlines()[-2:]) or "(no output)",
              flush=True)
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prepare")
    p.add_argument("out")
    p.add_argument("parent")
    r = sub.add_parser("run")
    r.add_argument("out")
    r.add_argument("trees", nargs="+")
    r.add_argument("--logs", default=None)
    a = ap.parse_args()
    if a.cmd == "prepare":
        prepare(a.out, a.parent)
        return 0
    return run(a.out, a.logs or os.path.join(a.out, "logs"), a.trees)


if __name__ == "__main__":
    sys.exit(main())
