#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

Drives the port's four paths and checks every result: the kernel
compiler's launch path — KernelBuilder DSL -> IR -> PassManager ->
WorkGroupPlan -> the hand-written ``cuda`` work-group target -> Context /
Program / Kernel launch — two serving paths — ``repro_torch.launch.
serve`` -> ``ServingEngine`` -> ``TorchExecutor`` -> the smollm-135m model
at its full published width, through the hand-written CUDA ``rmsnorm``
and ``decode_attention`` kernels, and the mamba2-780m model at its full
published width, through ``rmsnorm`` and the hand-written CUDA
``ssd_scan`` — and training: ``repro_torch.launch.train`` -> ``Trainer``
-> ``loss_fn`` -> smollm-135m at full width, through ``rmsnorm`` and the
hand-written CUDA ``flash_attention`` in the forward, with the blocked
backward behind it.  Each phase prints one JSON line; any mismatch, build error
or launch error raises and the script exits non-zero.

  1. device: the card, torch/CUDA versions, and one parallel ``nvcc``
     build of every kernel the run launches, the work-group kernels and
     the model kernels in one wave (seconds per kernel);
  2. quickstart (main path): the paper's Fig. 1 dot product at 1<<22
     work-items through Context -> Program -> Kernel -> launch, against
     numpy (``rtol=1e-5, atol=2e-6``, the quickstart's tolerance) and
     bitwise against the ``vector`` target, and at 256 work-items
     against the fiber oracle;
  3. compiler cases: every case of ``repro_torch.core.cases`` with and
     without the horizontal pass, ``cuda`` against the torch ``vector``
     target (its plain version) on the card, bitwise where the data is
     integer-valued and at ``rtol=1e-5, atol=1e-6`` otherwise;
  4. suite at ``full`` shapes, every tuning configuration: ``cuda``
     bitwise against the ``vector`` target and the numpy oracle;
  5. suite at real sizes (main path): bitwise against the oracle and
     the ``vector`` target, then timed with CUDA events (median of 20
     launches, L2 flushed before each) beside the plain version's time
     (median of 3), the bound and, where one PyTorch call computes the
     same function, that call's time; with each kernel's mapping
     (threads per block, the ``__syncthreads()`` kept in its source,
     direct region flow or not) and the static counts of a few
     instructions in its SASS (``cuobjdump -sass``);
  6. serving (main path): ``repro_torch.launch.serve`` at full width
     (30 layers, d 576, 9/3 heads, vocab 49152; random weights from seed
     0) with 8 slots and a 2048-token cache serves 16 requests (prompts
     of 32-512 tokens, 32-128 new tokens each, one arrival every 2
     scheduler steps): requests and tokens served, wall seconds, tok/s,
     the median decode-step time and both model kernels' launch counts
     (each must be > 0).  Four of the requests are re-run alone through
     an engine of the same width and must give identical streams; one
     prefill and 8 decode steps of 8 rows give logits that must agree
     with the same forward run through the kernels' plain versions:
     in bfloat16, as served, within ``atol=0.125`` (two bfloat16 ulps
     at the logits' size); in float32 with the same weights within
     ``atol=1e-3``, a limit that the same steps with decode attention
     given one key fewer or one more must fail.  Five decode steps of
     those 8 rows are profiled
     (``torch.profiler``): device busy time and idle share per step, the
     kernel launches per step and the kernels that take the most time;
  7. the model kernels at the serving path's shapes, each against its
     plain version on the same CUDA tensors (rmsnorm: rows 8 and 512, d
     576, float32 within ``rtol=1e-5, atol=1e-6``, bfloat16 within one
     bfloat16 ulp; decode attention: 8 x 9 heads over 3 KV heads of 64,
     a 2048-token bfloat16 cache, lengths from the seed with a 0 and a
     2048, within one bfloat16 ulp, ``rtol=2**-7, atol=1e-4``, and zeros
     for the empty row; every row must fail that tolerance against the
     plain version given its length minus or plus one), then timed like
     phase 5 beside their plain versions, their bounds and the PyTorch
     call that computes the same function (``F.rms_norm``;
     ``scaled_dot_product_attention`` with the length mask and
     ``enable_gqa=True``), which the port never calls;
  8. serving mamba2-780m (main path): ``repro_torch.launch.serve`` at
     full width (48 layers, d 1536, 48 SSD heads of 64, state 128, vocab
     50280; random weights from seed 0) with 8 slots and a 2048-token
     limit serves 8 requests (prompts of 32-512 tokens, each prefilled at
     its exact length, 32-64 new tokens, one arrival every 2 steps):
     requests and tokens served, wall seconds, tok/s, the median
     decode-step time and the ``ssd_scan`` and ``rmsnorm`` launch counts
     (each must be > 0).  Two requests re-run alone must give identical
     streams; one 64-token prefill and 8 decode steps of 8 rows give
     logits that must agree with the plain versions' run: in bfloat16,
     as served, within four bfloat16 ulps at the logits' largest size; in
     float32 with the same weights within ``atol=1e-3``, a limit that the
     plain run with its prefill state taken one token short must fail.
     One prefill and 5 decode steps are profiled as in phase 6;
  9. ``ssd_scan`` against its plain version on the same CUDA tensors, at
     the served prefill's shape (1 x 512 tokens x 48 heads x 64, state
     128, one group), at (4, 2048) of the same, and with 4 groups and a
     ragged s (1000), in bfloat16 and float32: y and the final state
     within ``SSD_F32_TOL`` (float32) and one bfloat16 ulp for a
     bfloat16 y, every case failing the state tolerance against the plain
     version given s - 1 steps; then timed like phase 5 beside the plain
     version's time and the bound (no single PyTorch call computes the
     scan, so no library time);
 10. ``flash_attention`` against its plain version, causal, at the
     training shape (8 x 9 heads over 3 KV heads x 2048 x 64, bfloat16),
     at D 128 with GQA, with Sq < Sk and at a ragged length in float32:
     the output and lse within ``FLASH_F32_TOL`` (float32) and one
     bfloat16 ulp for a bfloat16 output; then timed like phase 5 beside
     the plain version, the bound (both products at the bf16 tensor-core
     peak for a bfloat16 call, the FP32 peak for a float32 one) and
     ``scaled_dot_product_attention`` (causal, ``enable_gqa=True``),
     which the port never calls;
 11. training (main path): ``repro_torch.launch.train`` trains
     smollm-135m at full width (random weights from seed 0, the
     synthetic stream) for 20 steps of 8 x 2048 tokens with per-block
     remat, bf16 compute over f32 master weights: the loss of every
     step, which must fall by ``LOSS_DROP`` nats from step 0 to the mean
     of the last five, the median step time, tokens/s, peak memory, the
     launches per step (flash attention must run 60 times a step: 30
     layers, forward and recompute), and one more step profiled as in
     phase 6;
 12. the gradient check: one float32 step at full width (2 x 2048), the
     loss and every gradient leaf through the kernels against the same
     step through their plain versions, within ``GRAD_REL_TOL`` of each
     leaf's largest entry, a limit that the plain run with the causal
     mask shifted by one key must fail;
 13. the kernels line, then the card's name and power limit, then the
     result line.

Launch counts are set to 0 just before each main-path phase and read
just after it; launches made to compare a kernel with its plain version
do not count.

  python3 chip_smoke.py          # from the repository root, one card
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_FP32_FLOPS = 67e12      # H100 SXM, FP32 on CUDA cores (data sheet)
PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 on tensor cores (data sheet)
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s (data sheet)
KERNEL_SOURCE = "src/repro_torch/core/targets/cuda_target.py"
REPLACES = "src/repro/core/targets/pallas_target.py:36"
MODEL_KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:31"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:68"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:74"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
}

# phase 6: the serving run (through repro_torch.launch.serve)
SERVE = {"arch": "smollm-135m", "batch_slots": 8, "max_seq": 2048,
         "requests": 16, "prompt_len": (32, 512), "new_tokens": (32, 128),
         "arrival_every": 2, "seed": 0}
RERUN_ALONE = 4             # requests re-run alone, streams must be equal
LOGIT_STEPS = 8             # decode steps of the kernels-vs-plain check
# The served logits are bfloat16 (the tied head's product) and reach |9.4|
# at these weights, where one bfloat16 ulp is 0.0625: the largest
# difference the kernels have shown from their plain versions.  The limit
# is two such ulps, absolute.  Rounding flips carried through 30 bfloat16
# layers are as large as the effect of one key more or fewer in decode
# attention, so that fault is looked for in float32 (same weights, the
# cache still bfloat16), where the two sides differ by float32 rounding
# order only and one key moves the logits by about 1e-2 (PERF.md).
LOGIT_ATOL = 2 * 0.0625
LOGIT_ATOL_F32 = 1e-3
# decode attention, bfloat16 q: both sides read the same cache values,
# accumulate in float32 and round once, so one bfloat16 ulp
DEC_RTOL, DEC_ATOL = 2.0 ** -7, 1e-4

# phase 8: serving mamba2-780m (through repro_torch.launch.serve)
SSM_SERVE = {"arch": "mamba2-780m", "batch_slots": 8, "max_seq": 2048,
             "requests": 8, "prompt_len": (32, 512), "new_tokens": (32, 64),
             "arrival_every": 2, "seed": 0}
SSM_RERUN_ALONE = 2
# The served logits are bfloat16 and reach |5.1| at these weights, where
# one bfloat16 ulp is 2**-5.  After 48 bfloat16 layers the kernels' run
# differs from the plain versions' by up to 0.0859, 2.75 such ulps (the
# same in every run on the card, PERF.md; smollm's 30 layers show 1 ulp):
# one-ulp flips of the scan's and the norm's outputs, carried through
# the stack.  The limit is 4 ulps at the logits' largest size; it claims
# to see no fault.  The float32 run (same weights) does that: there the
# two sides differ by summation order only (7.2e-6), and a prefill state
# one token short moves the decode steps' logits by 0.445-0.555
SSM_LOGIT_ULPS_BF16 = 4
SSM_LOGIT_ATOL_F32 = 1e-3
# phase 9: ssd_scan cases, (b, s, h, p, g, n, chunk): the served prefill's
# shape first (its time is the kernels line's), then a long batch, then
# groups with a ragged s.  Both sides compute in float32 and differ in
# summation order and exp only: the float32 state and y within 1e-5 (the
# largest errors seen were 5.2e-6 at |state| <= 1.3 and 4.1e-6 at
# |y| <= 2 on the card, PERF.md); a bfloat16 y is rounded once, so one
# bfloat16 ulp
SSD_CASES = [(1, 512, 48, 64, 1, 128, 64), (4, 2048, 48, 64, 1, 128, 64),
             (2, 1000, 48, 64, 4, 128, 64)]
SSD_F32_TOL = {"rtol": 1e-5, "atol": 1e-5}
SSD_Y_BF16_TOL = {"rtol": 2.0 ** -7, "atol": 1e-6}

# phase 10: flash attention cases, causal, ((B, H, Hkv, Sq, Sk, D), dtype):
# the training shape first (its time is the kernels line's), then D = 128
# with GQA, Sq < Sk (the query block aligned to the key tail), and a
# ragged length in float32.  Both sides compute in float32 and differ in
# summation order and exp only: a float32 output and the lse within 1e-5;
# a bfloat16 output is rounded once, so one bfloat16 ulp
FLASH_CASES = [((8, 9, 3, 2048, 2048, 64), "bfloat16"),
               ((2, 16, 4, 1024, 1024, 128), "bfloat16"),
               ((4, 9, 3, 512, 2048, 64), "bfloat16"),
               ((2, 9, 3, 1000, 1000, 64), "float32")]
FLASH_F32_TOL = {"rtol": 1e-5, "atol": 1e-5}
FLASH_BF16_TOL = {"rtol": 2.0 ** -7, "atol": 1e-5}

# phase 11: training smollm-135m at full width (through
# repro_torch.launch.train): 16,384 tokens a step at the published
# context, per-block remat, bf16 compute over f32 master weights; the
# warmup is min(100, steps) = 20, as launch/train.py sets it
TRAIN = {"arch": "smollm-135m", "steps": 20, "batch": 8, "seq": 2048,
         "remat": "block", "lr": 3e-4, "seed": 0}
LOSS_DROP = 1.0             # nats, step 0 against the mean of the last 5
# phase 12: one step at full width in float32, batch 2 x 2048: the loss
# and every gradient leaf, kernels against their plain versions.  Both
# sides compute in float32 and differ in summation order and exp only;
# the gradients carry that through 30 layers' backward.  The limit is on
# max|kernels - plain| / max|plain| per leaf, and a planted fault (the
# causal mask shifted by one key) must fail it
GRAD_CHECK = {"arch": "smollm-135m", "batch": 2, "seq": 2048, "seed": 1}
GRAD_REL_TOL = 1e-3
LOSS_REL_TOL = 1e-5

# phase 5: real problem sizes and the configuration each runs with
REAL = [
    ("gemm", {"m": 2048, "n": 2048, "k": 2048}, {"ts": 16, "unroll": 16}),
    ("spmv", {"m": 1 << 20, "n": 1 << 20, "max_nnz": 8},
     {"lsz": 64, "unroll": 8}),
    ("stencil1d", {"n": 1 << 25}, {"lsz": 64, "use_local": 0}),
    ("stencil1d", {"n": 1 << 25}, {"lsz": 64, "use_local": 1}),
    ("stencil2d", {"h": 8192, "w": 8192}, {"tx": 16, "ty": 16}),
    ("scan", {"n": 1 << 24, "seg": 256}, {"unroll": 0}),
    ("hist", {"n": 1 << 24, "bins": 16}, {"lsz": 32, "ipt": 4}),
]
QS_N, QS_LSZ = 1 << 22, 64


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sass_counts(lib):
    """Static counts of shared loads and stores and of block barriers in
    a built library's SASS (``cuobjdump -sass``), or None where the tool
    is missing or fails."""
    from repro_torch.core.nvcc import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    try:
        r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                           text=True, timeout=120)
    except OSError:
        return None
    if r.returncode != 0:
        return None
    ops = []
    for ln in r.stdout.splitlines():
        toks = ln.split("*/", 1)[1].split() if "*/" in ln else []
        if toks and toks[0].startswith("@"):
            toks = toks[1:]
        if toks:
            ops.append(toks[0])
    return {k: sum(1 for o in ops if o.split(".")[0] == k)
            for k in ("LDS", "STS", "BAR", "FFMA", "FADD", "FMUL")}


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(flops, nbytes, bf16_flops=0.0):
    """The least time for the work, in ms, and what bounds it: ``flops``
    at the FP32 peak plus ``bf16_flops`` (products of two bf16 operands)
    at the bf16 tensor-core peak, against ``nbytes`` at the HBM rate."""
    t_ops = flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


@contextlib.contextmanager
def plain_kernels():
    """Run the model with each kernel's plain version in its wrapper's
    place (for the comparison only: the plain versions count no
    launches)."""
    from repro_torch.kernels import decode_attention as da, \
        flash_attention as fa, rmsnorm as rn, ssd_scan as ss
    saved = rn.rmsnorm, da.decode_attention, ss.ssd_scan, fa.flash_attention
    rn.rmsnorm, da.decode_attention, ss.ssd_scan, fa.flash_attention = \
        rn.rmsnorm_plain, da.decode_attention_plain, ss.ssd_scan_plain, \
        fa.flash_attention_plain
    try:
        yield
    finally:
        rn.rmsnorm, da.decode_attention, ss.ssd_scan, fa.flash_attention = \
            saved


@contextlib.contextmanager
def causal_mask_shifted():
    """Run the model with the plain versions and flash attention given
    the last key once more at the end, so that the causal mask, aligned
    to the key tail, lets every row see one key past its own (for the
    check that the gradient limit sees it); forward and backward alike."""
    import torch
    from repro_torch.models import flash as mf
    real = mf.FlashAttention

    class Shifted:
        @staticmethod
        def apply(q, k, v, *args):
            return real.apply(q, torch.cat([k, k[:, :, -1:]], 2),
                              torch.cat([v, v[:, :, -1:]], 2), *args)

    with plain_kernels():
        mf.FlashAttention = Shifted
        try:
            yield
        finally:
            mf.FlashAttention = real


@contextlib.contextmanager
def prefill_state_short():
    """Run the model with the plain versions and a scan whose final state
    is taken one token short (the last step dropped), for the check that
    the float32 logits' limit sees it: the prefill's logits are right,
    the decode steps carry the wrong state."""
    from repro_torch.kernels import ssd_scan as ss

    def short(x, dt, A, B, C, chunk=64):
        y, _ = ss.ssd_scan_plain(x, dt, A, B, C, chunk)
        _, st = ss.ssd_scan_plain(x[:, :-1], dt[:, :-1], A, B[:, :-1],
                                  C[:, :-1], chunk)
        return y, st

    with plain_kernels():
        ss.ssd_scan = short
        yield


@contextlib.contextmanager
def decode_lengths_shifted(shift):
    """Run the model with a decode attention that attends over ``shift``
    keys more than it is given: with -1 it drops the key just written,
    the fault of attending over ``lengths`` where the model asks for
    ``lengths + 1`` (for the check that the logits' limit sees it)."""
    from repro_torch.kernels import decode_attention as da
    saved = da.decode_attention
    da.decode_attention = lambda q, k, v, lengths: saved(q, k, v,
                                                         lengths + shift)
    try:
        yield
    finally:
        da.decode_attention = saved


def _profiled(torch, fn, steps):
    """``fn`` run ``steps`` times under ``torch.profiler``: the device's
    busy time (the sum of the kernels' own device times) against the wall
    time, the kernel launches per step, the kernels that take the most
    device time, and the operators whose own kernels do (PyTorch's
    generic elementwise kernels name no operator)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    by_name = {}            # names cut to 60 characters, their times summed
    for e in kernels:
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) \
            + e.self_device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ops = sorted((e for e in prof.key_averages()
                  if not str(e.device_type).endswith("CUDA")
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:10]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "kernel_launches_per_step": sum(e.count for e in kernels)
            / steps,
            "top_kernels_ms_per_step": {k: us / steps / 1e3
                                        for k, us in top},
            "top_ops_device_ms_per_step": {
                e.key: e.self_device_time_total / steps / 1e3 for e in ops}}


def profile_decode(torch, forward, init_caches, cfg, params, toks, max_seq,
                   dev, steps=5):
    """Where a decode step's time goes: ``steps`` decode steps of the
    8-row batch under ``torch.profiler`` (:func:`_profiled`)."""
    with torch.inference_mode():
        caches = init_caches(cfg, toks.shape[0], max_seq, device=dev)
        lg, _, caches = forward(params, toks, cfg, caches=caches,
                                mode="prefill")
        for _ in range(2):                      # warm up
            lg, _, caches = forward(params, lg[:, -1].argmax(-1)[:, None],
                                    cfg, caches=caches, mode="decode")
        state = {"lg": lg, "c": caches}

        def step():
            state["lg"], _, state["c"] = forward(
                params, state["lg"][:, -1].argmax(-1)[:, None], cfg,
                caches=state["c"], mode="decode")
        return _profiled(torch, step, steps)


def profile_prefill(torch, forward, init_caches, cfg, params, toks, max_seq,
                    dev):
    """Where a prefill's time goes: one prefill of the 8-row batch (after
    one to warm up) under ``torch.profiler`` (:func:`_profiled`)."""
    with torch.inference_mode():
        caches = init_caches(cfg, toks.shape[0], max_seq, device=dev)
        forward(params, toks, cfg, caches=caches, mode="prefill")
        return _profiled(torch, lambda: forward(
            params, toks, cfg, caches=caches, mode="prefill"), 1)


def logits_vs_plain(torch, forward, init_caches, mcfg, mparams, toks0,
                    max_seq, dev, faults):
    """One prefill of ``toks0`` and :data:`LOGIT_STEPS` decode steps.
    Per step, the largest |logit difference| from the plain versions'
    run: of the kernels, and of each fault (a name -> a context manager
    to run the same steps under, fed the same tokens).  Only the real
    vocabulary's logits are compared: the padded rows are -1e9 on both
    sides."""
    V = mcfg.vocab

    def run(feed=None):
        out, fed = [], []
        with torch.inference_mode():
            caches = init_caches(mcfg, toks0.shape[0], max_seq, device=dev)
            lg, _, caches = forward(mparams, toks0, mcfg, caches=caches,
                                    mode="prefill")
            out.append(lg[:, -1, :V].float())
            for i in range(LOGIT_STEPS):
                nxt = lg[:, -1, :V].argmax(-1)[:, None] if feed is None \
                    else feed[i]
                fed.append(nxt)
                lg, _, caches = forward(mparams, nxt, mcfg, caches=caches,
                                        mode="decode")
                out.append(lg[:, -1, :V].float())
        return out, fed

    got, fed = run()
    with plain_kernels():
        want, _ = run(fed)
    runs = {"kernels": got}
    for name, fault in faults.items():
        with fault():
            runs[name], _ = run(fed)
    torch.cuda.synchronize()
    res = {name: [float((a - b).abs().max()) for a, b in zip(xs, want)]
           for name, xs in runs.items()}
    res["max_abs_logit"] = max(float(b.abs().max()) for b in want)
    res["argmax_agree"] = min(
        float((a.argmax(-1) == b.argmax(-1)).float().mean())
        for a, b in zip(got, want))
    return res


def bf16_ulp(v):
    """One bfloat16 ulp at the size of ``v`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def serve_phase(torch, np, time_ms):
    """Phases 6 and 7: the serving path at full width, then the model
    kernels against their plain versions, timed.  Returns the kernels
    line's entries of the two kernels."""
    import torch.nn.functional as F
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import forward, init_caches
    from repro_torch.serving import Request, ServingEngine

    # -- 6. the serving run, with the launch counts of its kernels
    cfg = configs.get_config(SERVE["arch"])
    eng = serve.make_engine(cfg, SERVE["seed"], SERVE["batch_slots"],
                            SERVE["max_seq"])
    reqs = serve.make_requests(cfg, np.random.default_rng(SERVE["seed"]),
                               SERVE["requests"], SERVE["prompt_len"],
                               SERVE["new_tokens"])
    for k in KERNELS:
        k.launches = 0
    run = serve.serve(eng, reqs, SERVE["arrival_every"])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        serve.report(run)
    done = run["done"]
    assert len(done) == len(reqs) and all(r.done for r in reqs), \
        [(r.id, r.state, r.error) for r in reqs]
    for r in reqs:
        assert len(r.out_tokens) == r.max_new_tokens, r.id
        assert all(0 <= t < cfg.vocab for t in r.out_tokens), r.id
    assert launches["rmsnorm"] > 0 and launches["decode_attention"] > 0, \
        ("a model kernel was not launched on the serving path", launches)
    dev = eng.context.devices[0].torch_device
    assert dev.type == "cuda", dev

    # the same requests alone, through an engine of the same width
    alone = ServingEngine(cfg, eng.params, batch_slots=eng.B,
                          max_seq=eng.S, context=eng.context)
    for r in reqs[:RERUN_ALONE]:
        again = Request(prompt=r.prompt.copy(),
                        max_new_tokens=r.max_new_tokens)
        alone.generate([again])
        assert again.out_tokens == r.out_tokens, \
            ("stream changed when served alone", r.id)

    # logits: kernels against their plain versions, one prefill + decode
    # steps, in the served bfloat16 and in float32 (same weights); in
    # float32 the limit must also fail decode attention given one key
    # fewer or one more than the model asks for
    rng = np.random.default_rng(1)
    toks0 = torch.tensor(rng.integers(0, cfg.vocab, (8, 64)), device=dev)
    params = alone._exec.params

    def logits_check(mcfg, mparams):
        """Of the kernels, and of the kernels with decode attention's
        lengths one short and one long."""
        return logits_vs_plain(
            torch, forward, init_caches, mcfg, mparams, toks0, eng.S, dev,
            {"short_by_one": lambda: decode_lengths_shifted(-1),
             "long_by_one": lambda: decode_lengths_shifted(1)})

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    logits = {"bfloat16": logits_check(cfg, params),
              "float32": logits_check(cfg32, eng.params)}
    limits = {"bfloat16": LOGIT_ATOL, "float32": LOGIT_ATOL_F32}
    summary = log.getvalue().splitlines()[:4]
    prof = profile_decode(torch, forward, init_caches, cfg, params, toks0,
                          eng.S, dev)
    emit(6, path="repro_torch.launch.serve", serve=SERVE,
         config={"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                 "n_heads": cfg.n_heads, "n_kv": cfg.n_kv, "head_dim": cfg.hd,
                 "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype},
         requests=len(done), tokens=run["tokens"], wall_s=run["wall_s"],
         tok_s=run["tok_s"], decode_steps=run["decode_steps"],
         decode_step_ms_median=run["decode_step_ms_median"],
         prefill_calls=eng.compile_stats["prefill_calls"],
         launches=launches, summary=summary,
         rerun_alone_identical=RERUN_ALONE,
         logits_vs_plain=logits, logits_atol=limits, decode_profile=prof)
    for dt, res in logits.items():
        assert max(res["kernels"]) <= limits[dt], \
            ("logits, kernels vs plain", dt, res["kernels"], limits[dt])
    for fault in ("short_by_one", "long_by_one"):
        assert max(logits["float32"][fault]) > LOGIT_ATOL_F32, \
            ("the float32 logits' limit does not see decode attention "
             "with a length off by one", fault, logits["float32"][fault])

    # -- 7. each model kernel against its plain version, then timed
    entries = []
    d = cfg.d_model
    rms_err, rms_cases = 0.0, []
    for rows, xdt, wdt in ((8, torch.bfloat16, torch.bfloat16),
                           (8, torch.bfloat16, torch.float32),
                           (8, torch.float32, torch.float32),
                           (512, torch.bfloat16, torch.bfloat16),
                           (512, torch.float32, torch.float32)):
        x = (torch.tensor(rng.standard_normal((rows, d)), device=dev) * 3) \
            .to(xdt)
        w = torch.tensor(rng.standard_normal(d), device=dev).to(wdt)
        a, b = rmsnorm(x, w), rmsnorm_plain(x, w)
        if xdt == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7,
                                       atol=0)
        rms_err = max(rms_err, float((a.float() - b.float()).abs().max()))
        nbytes = rows * d * 2 * x.element_size() + d * w.element_size()
        ms = time_ms(lambda: rmsnorm(x, w))
        plain_ms = time_ms(lambda: rmsnorm_plain(x, w), reps=3, warmup=1)
        wl = w.to(xdt)
        lib_ms = time_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6))
        bms = nbytes / PEAK_HBM_BYTES * 1e3
        rms_cases.append({"rows": rows, "d": d, "x": str(xdt), "w": str(wdt),
                          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bms, "fraction_of_bound": bms / ms})
    emit(7, kernel="rmsnorm", cases=rms_cases, max_abs_err_vs_plain=rms_err,
         launches=launches["rmsnorm"])
    main_case = rms_cases[0]      # the decode step's shape and dtypes
    entries.append({"name": "rmsnorm", "source": MODEL_KERNELS["rmsnorm"][0],
                    "replaces": MODEL_KERNELS["rmsnorm"][1],
                    "launches": launches["rmsnorm"], "max_abs_err": rms_err,
                    "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                    "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
                    "library_ms": main_case["library_ms"]})

    B, H, Hkv, D, S = eng.B, cfg.n_heads, cfg.n_kv, cfg.hd, eng.S
    q = torch.tensor(rng.standard_normal((B, H, D)), device=dev) \
        .to(torch.bfloat16)
    kc = torch.tensor(rng.standard_normal((B, Hkv, S, D)), device=dev) \
        .to(torch.bfloat16)
    vc = torch.tensor(rng.standard_normal((B, Hkv, S, D)), device=dev) \
        .to(torch.bfloat16)
    lens = rng.integers(0, S + 1, B).astype(np.int32)
    lens[0], lens[1] = 0, S
    lengths = torch.tensor(lens, device=dev)
    a = decode_attention(q, kc, vc, lengths)
    b = decode_attention_plain(q, kc, vc, lengths)
    assert torch.all(a[0] == 0), "the row with no valid key is not zeros"
    torch.testing.assert_close(a.float(), b.float(), atol=DEC_ATOL,
                               rtol=DEC_RTOL)
    dec_err = float((a.float() - b.float()).abs().max())
    # the tolerance sees a length off by one, in every row it can
    for shift in (-1, 1):
        moved = (lengths + shift).clamp(0, S)
        other = decode_attention_plain(q, kc, vc, moved).float()
        for r in range(B):
            assert int(moved[r]) == int(lens[r]) or not torch.allclose(
                a[r].float(), other[r], rtol=DEC_RTOL, atol=DEC_ATOL), \
                ("decode attention tolerance misses a length off by one",
                 r, int(lens[r]), shift)
    ms = time_ms(lambda: decode_attention(q, kc, vc, lengths))
    plain_ms = time_ms(lambda: decode_attention_plain(q, kc, vc, lengths),
                       reps=3, warmup=1)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask, enable_gqa=True))
    nbytes = 2 * Hkv * D * 2 * int(lens.sum()) + 2 * B * H * D * 2 + 4 * B
    bms = nbytes / PEAK_HBM_BYTES * 1e3
    emit(7, kernel="decode_attention", B=B, H=H, Hkv=Hkv, D=D, S=S,
         lengths=lens.tolist(), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
         bound_ms=bms, fraction_of_bound=bms / ms, blocks=B * Hkv,
         max_abs_err_vs_plain=dec_err, launches=launches["decode_attention"])
    entries.append({"name": "decode_attention",
                    "source": MODEL_KERNELS["decode_attention"][0],
                    "replaces": MODEL_KERNELS["decode_attention"][1],
                    "launches": launches["decode_attention"],
                    "max_abs_err": dec_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": "bytes", "library_ms": lib_ms})
    return entries


def ssd_flops_bytes(b, s, h, p, g, n, chunk, esize):
    """The scan's work for these inputs, as (f32 flops, bf16 flops,
    bytes).  Per (b, h) and chunk of l real steps, with the causal
    triangle t = l (l + 1) / 2 that y_i's sum over j <= i needs: t x n
    (C B^T, two bf16 operands when esize is 2), t x p (W x), l x n x p
    (C S) and n x l x p (B^T x), the last three with a float32 operand;
    two operations per multiply-add.  Bytes: x, dt, B and C read once in
    their dtype, A once, y written once, the float32 final state written
    once."""
    L = min(chunk, s)
    lens = [L] * (s // L) + ([s % L] if s % L else [])
    tri = sum(l * (l + 1) // 2 for l in lens)
    cb = 2.0 * b * h * tri * n
    rest = 2.0 * b * h * (tri * p + sum(2 * l * n * p for l in lens))
    nbytes = (2 * b * s * h * p + b * s * h + 2 * b * s * g * n) * esize \
        + 4 * h + 4 * b * h * p * n
    if esize == 2:
        return rest, cb, nbytes
    return rest + cb, 0.0, nbytes


def ssm_serve_phase(torch, np, time_ms):
    """Phases 8 and 9: serving mamba2-780m at full width, then ssd_scan
    against its plain version, timed.  Returns the kernels line's entry
    of ssd_scan."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import forward, init_caches
    from repro_torch.serving import Request, ServingEngine

    # -- 8. the serving run, with the launch counts of its kernels
    cfg = configs.get_config(SSM_SERVE["arch"])
    eng = serve.make_engine(cfg, SSM_SERVE["seed"], SSM_SERVE["batch_slots"],
                            SSM_SERVE["max_seq"])
    reqs = serve.make_requests(cfg, np.random.default_rng(SSM_SERVE["seed"]),
                               SSM_SERVE["requests"], SSM_SERVE["prompt_len"],
                               SSM_SERVE["new_tokens"])
    for k in KERNELS:
        k.launches = 0
    run = serve.serve(eng, reqs, SSM_SERVE["arrival_every"])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        serve.report(run)
    done = run["done"]
    assert len(done) == len(reqs) and all(r.done for r in reqs), \
        [(r.id, r.state, r.error) for r in reqs]
    for r in reqs:
        assert len(r.out_tokens) == r.max_new_tokens, r.id
        assert all(0 <= t < cfg.vocab for t in r.out_tokens), r.id
    assert launches["ssd_scan"] > 0 and launches["rmsnorm"] > 0, \
        ("a model kernel was not launched on the serving path", launches)
    dev = eng.context.devices[0].torch_device
    assert dev.type == "cuda", dev

    alone = ServingEngine(cfg, eng.params, batch_slots=eng.B,
                          max_seq=eng.S, context=eng.context)
    for r in reqs[:SSM_RERUN_ALONE]:
        again = Request(prompt=r.prompt.copy(),
                        max_new_tokens=r.max_new_tokens)
        alone.generate([again])
        assert again.out_tokens == r.out_tokens, \
            ("stream changed when served alone", r.id)

    # logits: kernels against their plain versions, one 64-token prefill
    # and decode steps, in the served bfloat16 and in float32 (same weights);
    # in float32 the limit must also fail the plain run whose prefill
    # state is one token short
    rng = np.random.default_rng(2)
    toks0 = torch.tensor(rng.integers(0, cfg.vocab, (8, 64)), device=dev)
    params = alone._exec.params
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    logits = {
        "bfloat16": logits_vs_plain(torch, forward, init_caches, cfg, params,
                                    toks0, eng.S, dev, {}),
        "float32": logits_vs_plain(torch, forward, init_caches, cfg32,
                                   eng.params, toks0, eng.S, dev,
                                   {"state_one_token_short":
                                    prefill_state_short})}
    limits = {"bfloat16": SSM_LOGIT_ULPS_BF16
              * bf16_ulp(logits["bfloat16"]["max_abs_logit"]),
              "float32": SSM_LOGIT_ATOL_F32}
    prof = {"prefill": profile_prefill(torch, forward, init_caches, cfg,
                                       params, toks0, eng.S, dev),
            "decode": profile_decode(torch, forward, init_caches, cfg,
                                     params, toks0, eng.S, dev)}
    emit(8, path="repro_torch.launch.serve", serve=SSM_SERVE,
         config={"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                 "ssm_inner": cfg.ssm_inner, "ssm_heads": cfg.ssm_heads,
                 "ssm_head_dim": cfg.ssm_head_dim,
                 "ssm_state": cfg.ssm_state, "ssm_groups": cfg.ssm_groups,
                 "ssm_conv": cfg.ssm_conv, "ssm_chunk": cfg.ssm_chunk,
                 "vocab": cfg.vocab, "dtype": cfg.dtype},
         requests=len(done), tokens=run["tokens"], wall_s=run["wall_s"],
         tok_s=run["tok_s"], decode_steps=run["decode_steps"],
         decode_step_ms_median=run["decode_step_ms_median"],
         prefill_calls=eng.compile_stats["prefill_calls"],
         prefill_shapes=eng.compile_stats["prefill_shapes"],
         prompt_lens=[len(r.prompt) for r in reqs],
         launches=launches, summary=log.getvalue().splitlines()[:4],
         rerun_alone_identical=SSM_RERUN_ALONE,
         logits_vs_plain=logits, logits_atol=limits, profile=prof)
    for dt, res in logits.items():
        assert max(res["kernels"]) <= limits[dt], \
            ("logits, kernels vs plain", dt, res["kernels"], limits[dt])
    assert max(logits["float32"]["state_one_token_short"]) > \
        SSM_LOGIT_ATOL_F32, \
        ("the float32 logits' limit does not see a prefill state one token "
         "short", logits["float32"]["state_one_token_short"])
    del eng, alone, params
    torch.cuda.empty_cache()

    # -- 9. ssd_scan against its plain version, then timed
    cases, err = [], 0.0
    for i, (b, s, h, p, g, n, chunk) in enumerate(SSD_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(10 + i)

            def t(a, d=dtype):
                return torch.tensor(a, dtype=torch.float32, device=dev).to(d)
            x = t(rng.standard_normal((b, s, h, p)))
            dt = t(np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)))
            A = t(-rng.uniform(0.5, 1.5, h), torch.float32)
            B = t(rng.standard_normal((b, s, g, n)) / np.sqrt(n))
            C = t(rng.standard_normal((b, s, g, n)) / np.sqrt(n))
            y, st = ssd_scan(x, dt, A, B, C, chunk)
            py, pst = ssd_scan_plain(x, dt, A, B, C, chunk)
            _, short = ssd_scan_plain(x[:, :-1], dt[:, :-1], A, B[:, :-1],
                                      C[:, :-1], chunk)
            torch.cuda.synchronize()
            y_tol = SSD_F32_TOL if dtype == torch.float32 else SSD_Y_BF16_TOL
            torch.testing.assert_close(y.float(), py.float(), **y_tol)
            torch.testing.assert_close(st, pst, **SSD_F32_TOL)
            assert not torch.allclose(st, short, **SSD_F32_TOL), \
                ("ssd_scan state tolerance misses a scan one step short",
                 (b, s, h, p, g, n), str(dtype))
            y_err = float((y.float() - py.float()).abs().max())
            st_err = float((st - pst).abs().max())
            err = max(err, y_err, st_err)
            ms = time_ms(lambda: ssd_scan(x, dt, A, B, C, chunk))
            plain_ms = time_ms(lambda: ssd_scan_plain(x, dt, A, B, C, chunk),
                               reps=3, warmup=1)
            flops, bf16_flops, nbytes = ssd_flops_bytes(
                b, s, h, p, g, n, chunk, x.element_size())
            bms, by = bound(flops, nbytes, bf16_flops)
            cases.append({"shape": [b, s, h, p], "g": g, "n": n,
                          "chunk": chunk, "dtype": str(dtype), "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bms,
                          "bound_by": by, "fraction_of_bound": bms / ms,
                          "y_err": y_err, "state_err": st_err,
                          "short_state_diff": float((st - short).abs().max()),
                          "blocks": (p + 15) // 16 * h * b})
            del x, dt, B, C, y, st, py, pst, short
    emit(9, kernel="ssd_scan", cases=cases, max_abs_err_vs_plain=err,
         y_tol={"float32": SSD_F32_TOL, "bfloat16": SSD_Y_BF16_TOL},
         state_tol=SSD_F32_TOL, launches=launches["ssd_scan"],
         library_ms=None)
    main_case = cases[0]     # the served prefill's shape, bfloat16
    return [{"name": "ssd_scan", "source": MODEL_KERNELS["ssd_scan"][0],
             "replaces": MODEL_KERNELS["ssd_scan"][1],
             "launches": launches["ssd_scan"], "max_abs_err": err,
             "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
             "bound_ms": main_case["bound_ms"],
             "bound_by": main_case["bound_by"], "library_ms": None}]


def flash_flops_bytes(B, H, Hkv, Sq, Sk, D, esize):
    """Causal flash attention's work for these inputs, as (flops, bytes).
    Flops: the two products over the (query, key) pairs the mask lets
    through, row i seeing min(max(i + Sk - Sq + 1, 0), Sk) keys, two
    operations per multiply-add.  Bytes: q, k, v read once and o written
    once in their dtype, the float32 lse written once."""
    rows = [min(max(i + Sk - Sq + 1, 0), Sk) for i in range(Sq)]
    flops = 2.0 * 2.0 * B * H * D * sum(rows)
    nbytes = (2 * B * H * Sq * D + 2 * B * Hkv * Sk * D) * esize \
        + 4 * B * H * Sq
    return flops, nbytes


def flash_phase(torch, np, time_ms, dev):
    """Phase 10: flash attention against its plain version at
    :data:`FLASH_CASES`, timed like phase 5 beside the plain version, the
    bound and ``scaled_dot_product_attention`` (the causal mask aligned
    to the key tail, GQA by ``enable_gqa``), which the port never calls.
    Returns the cases."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cases = []
    for i, ((B, H, Hkv, Sq, Sk, D), dt) in enumerate(FLASH_CASES):
        dtype = getattr(torch, dt)
        rng = np.random.default_rng(20 + i)

        def t(shape):
            return torch.tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=dev).to(dtype)
        q, k, v = t((B, H, Sq, D)), t((B, Hkv, Sk, D)), t((B, Hkv, Sk, D))
        o, lse = flash_attention(q, k, v, causal=True)
        po, plse = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        torch.testing.assert_close(o.float(), po.float(), **tol)
        torch.testing.assert_close(lse, plse, **FLASH_F32_TOL)
        o_err = float((o.float() - po.float()).abs().max())
        lse_err = float((lse - plse).abs().max())
        del po, plse
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                           reps=3, warmup=1)
        mask = None if Sq == Sk else \
            (torch.arange(Sk, device=dev)[None, :]
             <= torch.arange(Sq, device=dev)[:, None] + (Sk - Sq))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=True))
        flops, nbytes = flash_flops_bytes(B, H, Hkv, Sq, Sk, D,
                                          q.element_size())
        bms, by = bound(0.0, nbytes, flops) if dtype == torch.bfloat16 \
            else bound(flops, nbytes)
        cases.append({"shape": [B, H, Hkv, Sq, Sk, D], "dtype": dt,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bms, "bound_by": by,
                      "fraction_of_bound": bms / ms, "flops": flops,
                      "bytes": nbytes, "o_err": o_err, "lse_err": lse_err,
                      "blocks": B * H * ((Sq + 63) // 64)})
        del q, k, v, o, lse
    emit(10, kernel="flash_attention", cases=cases,
         tol={"float32": FLASH_F32_TOL, "bfloat16": FLASH_BF16_TOL},
         library="scaled_dot_product_attention(enable_gqa=True), causal "
                 "aligned to the key tail")
    return cases


def train_phase(torch, np):
    """Phase 11 (main path): ``repro_torch.launch.train`` at :data:`TRAIN`,
    with the launch counts of its kernels, the loss of every step, the
    median step time, tokens/s and peak memory; then one more step
    profiled (:func:`_profiled`).  Returns the launch counts."""
    from repro_torch.data import data_iterator
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train

    argv = ["--arch", TRAIN["arch"], "--steps", str(TRAIN["steps"]),
            "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
            "--remat", TRAIN["remat"], "--lr", str(TRAIN["lr"]),
            "--log-every", "1", "--seed", str(TRAIN["seed"])]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    for k in KERNELS:
        k.launches = 0
    with contextlib.redirect_stdout(log):
        run = train.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    trainer, steps = run["trainer"], TRAIN["steps"]
    cfg = trainer.cfg
    assert trainer.device.type == "cuda", trainer.device
    losses = [h["loss"] for h in run["history"]]
    assert len(losses) == steps and all(math.isfinite(x) for x in losses), \
        losses
    drop = losses[0] - sum(losses[-5:]) / 5
    it = data_iterator(cfg, TRAIN["batch"], TRAIN["seq"], start_step=steps,
                       seed=TRAIN["seed"])
    prof = _profiled(torch, lambda: trainer.run(it, 1), 1)
    it.close()
    emit(11, path="repro_torch.launch.train", train=TRAIN,
         config={"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                 "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
                 "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                 "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
                 "remat": cfg.remat, "use_kernels": cfg.use_kernels},
         losses=losses, loss_drop=drop,
         grad_norms=[h["grad_norm"] for h in run["history"]],
         lrs=[h["lr"] for h in run["history"]],
         step_s=run["step_seconds"], step_median_s=run["step_median_s"],
         tokens_per_step=run["tokens_per_step"],
         tokens_per_s=run["tokens_per_s"], wall_s=run["wall_s"],
         peak_memory_gb=peak / 1e9, launches=launches,
         launches_per_step={k: v / steps for k, v in launches.items()},
         summary=log.getvalue().splitlines()[:3], step_profile=prof)
    assert launches["flash_attention"] == 2 * cfg.n_layers * steps, \
        ("flash attention is launched once per layer in the forward and "
         "once in its recompute", launches)
    assert launches["rmsnorm"] > 0, launches
    assert drop >= LOSS_DROP, ("the loss did not fall", losses[0], drop)
    del run, trainer
    torch.cuda.empty_cache()
    return launches


def grad_check_phase(torch, np, dev):
    """Phase 12: the loss and every gradient leaf of one float32 step at
    full width (:data:`GRAD_CHECK`), kernels against their plain versions,
    and the planted fault of :func:`causal_mask_shifted`."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import synth_batch
    from repro_torch.models import init_params, loss_fn

    cfg = dataclasses.replace(configs.get_config(GRAD_CHECK["arch"]),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(
        GRAD_CHECK["seed"]), device=dev)
    batch = {k: torch.tensor(v, dtype=torch.int64, device=dev)
             for k, v in synth_batch(cfg, GRAD_CHECK["batch"],
                                     GRAD_CHECK["seq"], 0,
                                     GRAD_CHECK["seed"]).items()}

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree)
                    for x in leaves(tree[k], f"{path}/{k}")]
        return [(path, tree)]
    flat = leaves(params)
    for _, p in flat:
        p.requires_grad_(True)

    def run(ctx):
        with ctx():
            loss, _ = loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, [p for _, p in flat])
        torch.cuda.synchronize()
        return float(loss.detach()), grads

    k_loss, k_grads = run(contextlib.nullcontext)
    p_loss, p_grads = run(plain_kernels)
    f_loss, f_grads = run(causal_mask_shifted)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    kernels = {path: rel(a, b)
               for (path, _), a, b in zip(flat, k_grads, p_grads)}
    fault = {path: rel(a, b)
             for (path, _), a, b in zip(flat, f_grads, p_grads)}
    emit(12, check="gradients, kernels vs plain", config=GRAD_CHECK,
         dtype=cfg.dtype, loss={"kernels": k_loss, "plain": p_loss,
                                "causal_mask_shifted": f_loss},
         grad_rel_err=kernels, fault_grad_rel_err=fault,
         grad_rel_tol=GRAD_REL_TOL, loss_rel_tol=LOSS_REL_TOL)
    assert abs(k_loss - p_loss) <= LOSS_REL_TOL * abs(p_loss), \
        ("loss, kernels vs plain", k_loss, p_loss)
    assert max(kernels.values()) <= GRAD_REL_TOL, \
        ("gradients, kernels vs plain", kernels)
    assert max(fault.values()) > GRAD_REL_TOL, \
        ("the gradient limit does not see a causal mask shifted by one key",
         fault)
    del params, k_grads, p_grads, f_grads
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the repro_torch package is not under {SRC}; "
              f"run from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch.core import KernelBuilder
    from repro_torch.core.cases import CASES, build_dot_product, builder
    from repro_torch.core.interp import run_ndrange
    from repro_torch.core.nvcc import build_parallel
    from repro_torch.kernels import KERNELS
    from repro_torch.runtime import Context
    from repro_torch.suite import SUITE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    ctx = Context()
    cuda_dev = ctx.platform.get_devices("cuda")[0]
    vec_dev = ctx.platform.get_devices("vector")[0]
    dev = cuda_dev.torch_device

    # -- every kernel the run launches, compiled up front ----------------------
    dot_prog = ctx.create_program(builder(build_dot_product,
                                          KernelBuilder)).build()
    case_runs = []
    for seed, (case, (build, mk, gsz, lsz, sc)) in enumerate(CASES.items()):
        for hz in (True, False):
            prog = ctx.create_program(builder(build, KernelBuilder),
                                      horizontal=hz).build()
            case_runs.append((case, hz, seed, prog, mk, gsz, lsz, sc or {}))
    full_runs = []
    for name, sk in SUITE.items():
        shape = sk.shapes["full"]
        for params in sk.space(shape):
            full_runs.append((name, sk, shape, params,
                              ctx.create_program(sk.build(shape, params))))
    real_runs = [(name, SUITE[name], shape, params,
                  ctx.create_program(SUITE[name].build(shape, params)))
                 for name, shape, params in REAL]
    binaries = [dot_prog.create_kernel().bind(cuda_dev, (QS_LSZ,))]
    binaries += [r[3].create_kernel().bind(cuda_dev, r[6]) for r in case_runs]
    for runs in (full_runs, real_runs):
        for name, sk, shape, params, prog in runs:
            binaries.append(prog.create_kernel().bind(
                cuda_dev, sk.launch_dims(shape, params)[1]))
    progs = {b.prog.digest: b.prog for b in binaries}
    t0 = time.perf_counter()
    secs = build_parallel([p.nvcc_job() for p in progs.values()]
                          + [k.nvcc_job() for k in KERNELS])
    props = torch.cuda.get_device_properties(0)
    emit(1, gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         sms=props.multi_processor_count,
         smem_optin=getattr(props, "shared_memory_per_block_optin", None),
         kernels=len(progs), build_wall_s=time.perf_counter() - t0,
         model_kernels=len(KERNELS),
         nvcc_s={**{f"{p.wg.fn.name}@{p.lsz[:p.wg.fn.ndim]}":
                    secs.get(p.nvcc_job().out) for p in progs.values()},
                 **{k.name: secs.get(k.lib_path) for k in KERNELS}})

    def reset_counts():
        for p in progs.values():
            p.launches = 0

    # -- 2. quickstart through the host API (main path) --------------------------
    rng = np.random.default_rng(0)
    a = rng.standard_normal(QS_N * 4).astype(np.float32)
    b = rng.standard_normal(QS_N * 4).astype(np.float32)
    dot = dot_prog.create_kernel()
    dot.set_args(a=a, b=b, c=np.zeros(QS_N, np.float32))
    reset_counts()
    out = ctx.launch(dot, (QS_N,), (QS_LSZ,), target="cuda")
    torch.cuda.synchronize()
    dot_bin = dot.bind(cuda_dev, (QS_LSZ,))
    dot_launches = dot_bin.prog.launches
    expect = (a.reshape(-1, 4).astype(np.float64)
              * b.reshape(-1, 4)).sum(1).astype(np.float32)
    np.testing.assert_allclose(out["c"].cpu().numpy(), expect, rtol=1e-5,
                               atol=2e-6)
    small = {"a": a[:1024].copy(), "b": b[:1024].copy(),
             "c": np.zeros(256, np.float32)}
    fiber = run_ndrange(build_dot_product(KernelBuilder), (256,), (QS_LSZ,),
                        {k: v.copy() for k, v in small.items()})
    dot.set_args(**small)
    got = ctx.launch(dot, (256,), (QS_LSZ,))["c"].cpu().numpy()
    np.testing.assert_allclose(got, fiber["c"], rtol=1e-5, atol=2e-6)
    dot.set_args(a=a, b=b, c=np.zeros(QS_N, np.float32))
    plain = ctx.launch(dot, (QS_N,), (QS_LSZ,), device=vec_dev)
    dot_err = float((out["c"] - plain["c"]).abs().max())
    assert dot_err == 0.0, ("dot_product", "cuda vs vector", dot_err)
    emit(2, kernel="dot_product", work_items=QS_N, local_size=QS_LSZ,
         launches=dot_launches, numpy_rtol=1e-5, numpy_atol=2e-6,
         fiber_n=256, max_abs_err_vs_plain=dot_err)

    # -- 3. compiler cases: cuda against the vector target on the card ----------
    worst = 0.0
    for case, hz, seed, prog, mk, gsz, lsz, sc in case_runs:
        bufs = mk(np.random.default_rng(seed))
        k = prog.create_kernel()
        k.set_args(**bufs, **sc)
        got = ctx.launch(k, gsz, lsz)
        ref = ctx.launch(k, gsz, lsz, device=vec_dev)
        for name in bufs:
            g, r = got[name].cpu().numpy(), ref[name].cpu().numpy()
            exact = all(np.array_equal(v, np.round(v)) for v in bufs.values())
            if exact:
                assert g.tobytes() == r.tobytes(), (case, hz, name)
            else:
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{case} hz={hz} {name}")
            worst = max(worst, float(np.abs(g - r).max()))
    emit(3, cases=len(case_runs), rtol=1e-5, atol=1e-6,
         max_abs_err_vs_plain=worst)

    # -- 4. suite at full shapes, every configuration ---------------------------
    for name, sk, shape, params, prog in full_runs:
        inputs = sk.make_inputs(shape, params)
        expected = sk.oracle(inputs, shape, params)
        k = prog.create_kernel()
        k.set_args(**inputs)
        gsz, lsz = sk.launch_dims(shape, params)
        got = ctx.launch(k, gsz, lsz)
        ref = ctx.launch(k, gsz, lsz, device=vec_dev)
        for o in sk.outputs:
            g = got[o].cpu().numpy()
            assert g.tobytes() == ref[o].cpu().numpy().tobytes(), \
                (name, params, o, "cuda vs vector")
            assert g.tobytes() == expected[o].tobytes(), \
                (name, params, o, "cuda vs oracle")
    emit(4, configs=len(full_runs), bitwise=True)

    # -- 5. suite at real sizes (main path), then timing ----------------------------
    prepared = []
    reset_counts()
    for name, sk, shape, params, prog in real_runs:
        t_in = time.perf_counter()
        inputs = sk.make_inputs(shape, params)
        if name == "gemm":
            # every partial sum of the integer-valued operands is an
            # integer below 2**24, so the float64 product is exact and
            # equals the oracle's ordered float32 sum bitwise
            m, n, kk = shape["m"], shape["n"], shape["k"]
            expected = {"C": (inputs["A"].reshape(m, kk).astype(np.float64)
                              @ inputs["B"].reshape(kk, n)
                              .astype(np.float64)).astype(np.float32)
                        .reshape(-1)}
        else:
            expected = sk.oracle(inputs, shape, params)
        k = prog.create_kernel()
        k.set_args(**inputs)
        gsz, lsz = sk.launch_dims(shape, params)
        got = ctx.launch(k, gsz, lsz)
        for o in sk.outputs:
            assert got[o].cpu().numpy().tobytes() == expected[o].tobytes(), \
                (name, shape, params, o)
        prepared.append((name, sk, shape, params, k, inputs, gsz, lsz,
                         time.perf_counter() - t_in))
    torch.cuda.synchronize()
    counts = {id(p): p.launches for p in progs.values()}

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for s, e in ev:
            flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        ts = sorted(s.elapsed_time(e) for s, e in ev)
        return ts[len(ts) // 2]

    entries = []
    qs_bytes = 4.0 * (4 * QS_N * 2 + QS_N)
    dev_qs = {"a": torch.tensor(a, device=dev), "b": torch.tensor(b, device=dev),
              "c": torch.zeros(QS_N, device=dev)}
    vec_dot = dot.bind(vec_dev, (QS_LSZ,))
    ms = time_ms(lambda: dot_bin.launch_ndrange(dev_qs, (QS_N,)))
    plain_ms = time_ms(lambda: vec_dot.launch_ndrange(dev_qs, (QS_N,)),
                       reps=3, warmup=1)
    a2, b2 = dev_qs["a"].view(-1, 4), dev_qs["b"].view(-1, 4)
    lib_ms = time_ms(lambda: torch.linalg.vecdot(a2, b2))
    bms, by = bound(8.0 * QS_N, qs_bytes)
    entries.append({"name": "cuda_target/dot_product", "launches": dot_launches,
                    "max_abs_err": dot_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})

    for name, sk, shape, params, k, inputs, gsz, lsz, setup_s in prepared:
        binary = k.bind(cuda_dev, lsz)
        plain_bin = k.bind(vec_dev, lsz)
        dbufs = {n: torch.tensor(v, device=dev) for n, v in inputs.items()}
        pbufs = {n: t.clone() for n, t in dbufs.items()}
        binary.launch_ndrange(dbufs, gsz)
        plain_bin.launch_ndrange(pbufs, gsz)
        err = max(float((dbufs[o].double() - pbufs[o].double()).abs().max())
                  for o in sk.outputs)
        assert err == 0.0, (name, params, "cuda vs vector", err)
        ms = time_ms(lambda: binary.launch_ndrange(dbufs, gsz))
        plain_ms = time_ms(lambda: plain_bin.launch_ndrange(pbufs, gsz),
                           reps=3, warmup=0)
        lib_ms = None
        if name == "gemm":
            A = dbufs["A"].view(shape["m"], shape["k"])
            B = dbufs["B"].view(shape["k"], shape["n"])
            lib_ms = time_ms(lambda: torch.matmul(A, B))
        elif name == "scan":
            x = dbufs["x"].view(-1, shape["seg"])
            lib_ms = time_ms(lambda: x.cumsum(1))
        elif name == "spmv":
            with warnings.catch_warnings():   # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                csr = torch.sparse_csr_tensor(
                    dbufs["rowptr"], dbufs["cols"], dbufs["vals"],
                    (shape["m"], shape["n"]))
            xv = dbufs["x"].view(-1, 1)
            lib_ms = time_ms(lambda: torch.sparse.mm(csr, xv))
        nbytes = sum(v.nbytes for n, v in inputs.items()
                     if n not in sk.outputs) \
            + sum(inputs[o].nbytes for o in sk.outputs)
        bms, by = bound(sk.flops(shape), nbytes)
        label = f"cuda_target/{name}" + (
            f"_local{params['use_local']}" if name == "stencil1d" else "")
        launches = counts[id(binary.prog)]
        prog = binary.prog
        emit(5, kernel=label, shape=shape, params=params, ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
             fraction_of_bound=bms / ms, launches=launches,
             threads_per_block=prog.L,
             barriers=prog.source.count("__syncthreads();"),
             direct=prog.mapping.direct,
             sass=sass_counts(prog.nvcc_job().out),
             inputs_and_oracle_s=setup_s,
             tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32})
        assert launches > 0, (label, "not launched on the main path")
        entries.append({"name": label, "launches": launches,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": lib_ms})
        del dbufs, pbufs
        torch.cuda.empty_cache()
    assert dot_launches > 0

    # -- 6. serving at full width (main path) ----------------------------------------
    entries += serve_phase(torch, np, time_ms)
    torch.cuda.empty_cache()

    # -- 8. serving mamba2-780m at full width (main path) ----------------------------
    entries += ssm_serve_phase(torch, np, time_ms)
    torch.cuda.empty_cache()

    # -- 10-12. flash attention, training (main path), the gradient check ----------
    flash_cases = flash_phase(torch, np, time_ms, dev)
    train_launches = train_phase(torch, np)
    grad_check_phase(torch, np, dev)
    main_case = flash_cases[0]            # the training shape, bfloat16
    entries.append({
        "name": "flash_attention", "source": MODEL_KERNELS["flash_attention"][0],
        "replaces": MODEL_KERNELS["flash_attention"][1],
        "launches": train_launches["flash_attention"],
        "max_abs_err": max(c["o_err"] for c in flash_cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]})

    # -- 13. kernels line, card, result --------------------------------------------
    print(json.dumps({"kernels": [
        {"name": e["name"], "route": "cuda",
         "source": e.get("source", KERNEL_SOURCE),
         "replaces": e.get("replaces", REPLACES), "launches": e["launches"],
         "max_abs_err": e["max_abs_err"], "ms": e["ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
         "bound_by": e["bound_by"], "library_ms": e["library_ms"],
         "held_against_plain": True} for e in entries]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
