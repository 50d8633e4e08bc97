#!/usr/bin/env python3
"""Run ``chip_smoke.py`` on several trees in turns and tabulate its times.

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
prints a table of the phase-5 kernels (ms, threads per block, the
``__syncthreads()`` kept in the source, direct region flow, static SASS
counts), then one line per phase of the model kernels and the paths
that run them: phase 7's decode attention and rmsnorm, phase 10's flash
cases, serving's tok/s, decode-step ms and device time a step (phases 6
and 8), training's median step and device time a step (phase 11).  It
exits non-zero if any run fails.

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


def _ms(x):
    return "-" if x is None else f"{x:.4f}"


def summary(d: dict) -> str:
    """One line of a phase past 5: the numbers the comparison reads."""
    p = d.get("phase")
    if p in (6, 8):
        prof = d.get("decode_profile") or (d.get("profile") or {}).get(
            "decode", {})
        return (f"phase {p} {d.get('path')} {d['serve']['arch']}: "
                f"{d['tok_s']:.1f} tok/s, decode step "
                f"{d['decode_step_ms_median']:.2f} ms, device "
                f"{prof.get('device_busy_ms_per_step', 0):.3f} ms/step, "
                f"idle {prof.get('device_idle_share', 0):.3f}, "
                f"launches {d['launches']}")
    if p == 7 and "cases" in d:
        graph = d["cases"][0].get("graph_replay")
        return " ".join([f"phase 7 {d['kernel']}:"] + [
            f"{c['rows']}x{c['d']} {c['x'][6:]}/{c['w'][6:]} "
            f"{_ms(c['ms'])} (lib {_ms(c['library_ms'])})"
            for c in d["cases"]] + [f"graph replay {graph}"])
    if p == 7:
        return (f"phase 7 {d['kernel']}: {_ms(d['ms'])} ms, plain "
                f"{_ms(d['plain_ms'])}, library {_ms(d['library_ms'])}, "
                f"bound {d['bound_ms']:.5f}, blocks {d.get('blocks')}, "
                f"err {d['max_abs_err_vs_plain']:.3g}, graph replay "
                f"{d.get('graph_replay')}")
    if p == 9:
        return " ".join([f"phase 9 {d['kernel']} (sass {d.get('bf16_sass')}):"]
                        + [f"{c['shape']} {c['dtype'][6:]} {_ms(c['ms'])}"
                           f" ({c.get('cuda_launches_per_call')} launches"
                           + (f", graph {_ms(c['graph_ms'])}"
                              if "graph_ms" in c else "")
                           + (f", kernels {c['profile']['top_kernels_ms_per_step']}"
                              if "profile" in c else "") + ")"
                           for c in d["cases"]])
    if p == 10:
        return " ".join([f"phase 10 {d['kernel']} (tensor-core "
                         f"instructions {d.get('bf16_tensor_core_instructions')}"
                         f"):"] + [
            f"{c['shape']} {c['dtype']} {_ms(c['ms'])} (lib "
            f"{_ms(c['library_ms'])}, bound {c['bound_ms']:.5f}, o_err "
            f"{c['o_err']:.3g})" for c in d["cases"]])
    if p == 11:
        prof = d.get("step_profile", {})
        return (f"phase 11 train: step median {d['step_median_s']:.4f} s, "
                f"{d['tokens_per_s']:.0f} tokens/s, loss {d['losses'][0]:.4f}"
                f" -> {d['losses'][-1]:.4f}, device "
                f"{prof.get('device_busy_ms_per_step', 0):.1f} ms/step, "
                f"idle {prof.get('device_idle_share', 0):.3f}, peak "
                f"{d['peak_memory_gb']:.2f} GB")
    if p == 12:
        return (f"phase 12 grad check: max rel "
                f"{max(d['grad_rel_err'].values()):.3g}, fault "
                f"{max(d['fault_grad_rel_err'].values()):.3g}")
    return f"phase {p}"


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
            if not ln.startswith('{"phase"'):
                continue
            d = json.loads(ln)
            if d.get("phase") == 5:
                print(f"{d['kernel']:32s} {d['ms']:.4f} ms  "
                      f"threads {d.get('threads_per_block')}  "
                      f"barriers {d.get('barriers')}  "
                      f"direct {d.get('direct')}  sass {d.get('sass')}")
            else:
                print(summary(d))
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
