"""Recompute the derived roofline fields of stored dry-run records from
their raw measurements (idempotent; for when the metric definitions
improve without tracing the cells again).

The port of ``repro.launch.rederive``, over the H100's figures
(:data:`.mesh.HW`):

  PYTHONPATH=src python -m repro_torch.launch.rederive [results/dryrun]
"""

from __future__ import annotations

import glob
import json
import sys

from .mesh import HW


def rederive(rec: dict) -> dict:
    ideal = rec.get("ideal_gbytes", 0.0)
    art = rec.get("cpu_artifact_gbytes", 0.0)
    hlo_adj = max(rec["hlo_gbytes"] - art, ideal, 0.0)
    t_mem_adj = hlo_adj * 1e9 / HW["hbm_bw"]
    t_comp_eff = max(rec["t_compute"],
                     rec.get("executed_gflops_per_chip", 0.0) * 1e9
                     / HW["peak_flops_bf16"])
    terms = {"compute": t_comp_eff, "memory": t_mem_adj,
             "collective": rec["t_collective"]}
    dominant = max(terms, key=terms.get)
    t_bound = max(terms.values())
    if rec.get("kind") == "decode":
        t_ideal = ideal * 1e9 / HW["hbm_bw"]
        roofline = min(1.0, t_ideal / max(t_bound, 1e-12))
    else:
        t_useful = rec["model_gflops_per_chip"] * 1e9 \
            / HW["peak_flops_bf16"]
        roofline = t_useful / max(t_bound, 1e-12)
    rec.update(hlo_gbytes_adj=hlo_adj, t_memory_adj=t_mem_adj,
               t_compute_eff=t_comp_eff, dominant=dominant,
               t_bound=t_bound, roofline_fraction=roofline,
               bw_fraction=min(1.0, ideal / max(hlo_adj, 1e-9)))
    return rec


def main(base: str = "results/dryrun") -> int:
    n = 0
    for f in glob.glob(f"{base}/**/*.json", recursive=True):
        with open(f) as fh:
            rec = json.load(fh)
        if "hlo_gbytes" not in rec:
            continue
        with open(f, "w") as fh:
            json.dump(rederive(rec), fh, indent=1)
        n += 1
    print(f"rederived {n} records under {base}")
    return n


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
