#!/usr/bin/env python3
"""Print how close the port's training gradients come to the reference's.

For every case of ``tests/test_torch_training_families*.py`` (mamba2 at
16 and 12 tokens, zamba2, granite-moe, llama-3.2-vision and whisper;
kernels on and off; remat ``none`` and ``block``) and for the planted
fault (``SSDScan``'s backward given dt one step off, mamba2 at 16
tokens, remat ``none``), it computes each gradient leaf's reading: the
least atol, as a fraction of the leaf's largest entry, that the tests'
check passes at their ``GRAD_RTOL``.  One JSON line a case: the largest
reading and the leaves above ``1e-6``, each with its reading.  The last
line gives the largest reading of each family and the fault's smallest
reading over the mixer's leaves.  CPU only, a few minutes.

  JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/grad_atol_readings.py
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]

import test_torch_training_families as fam  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from test_torch_ssd_grad import dt_shifted  # noqa: E402

CASES = ([("mamba2-780m", seq) for seq in (16, 12)]
         + [(arch, 16) for arch in ("zamba2-7b", "granite-moe-3b-a800m",
                                     "llama-3.2-vision-11b",
                                     "whisper-small")])


def readings(arch, seq, remat, kernels):
    tcfg, _, jg, (_, _, paths, grads) = fam.both_gradients(
        arch, seq, remat, kernels)
    return tcfg.family, fam.atol_readings(paths, grads, jg)


def main():
    largest = {}
    for arch, seq in CASES:
        for remat in ("none", "block"):
            for kernels in (True, False):
                family, r = readings(arch, seq, remat, kernels)
                top = max(r.values())
                largest[family] = max(largest.get(family, 0.0), top)
                print(json.dumps({
                    "arch": arch, "seq": seq, "remat": remat,
                    "kernels": kernels, "largest": top,
                    "above_1e-6": {p: v for p, v in sorted(r.items())
                                   if v > 1e-6}}), flush=True)
    real = tssd.ssd_scan_reference
    tssd.ssd_scan_reference = dt_shifted(real)
    try:
        _, fault = readings("mamba2-780m", 16, "none", True)
    finally:
        tssd.ssd_scan_reference = real
    mixer = {p: v for p, v in fault.items() if "/mixer/" in p}
    print(json.dumps({"fault": "dt_shifted", "readings": fault}))
    print(json.dumps({"largest": largest,
                      "fault_mixer_smallest": min(mixer.values()),
                      "fault_largest": max(fault.values())}))


if __name__ == "__main__":
    main()
