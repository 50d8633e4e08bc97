#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

Drives the port's paths and checks every result: the kernel
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
backward behind it — and the OpenCL host runtime: device-resident
buffers, maps through a host bounce, an event-DAG queue whose fusion
rewrite stitches a chain of kernels into one ``cuda`` launch, and the
Chrome trace — and co-execution of one NDRange over several devices
(two ``cuda`` devices of the card, the card and the host) with the
per-kernel autotuner's ``auto`` device — and Vecmathlib in the ``cuda``
target's kernels (``use_vml=True``, ``csrc/vml.cuh``) and the
performance-portability scoreboard over the targets at the card's sizes.
Each phase prints one JSON line
or more; any mismatch, build error or launch error raises and the script
exits non-zero.

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
  7. the model kernels at the serving and training paths' shapes, each
     against its plain version on the same CUDA tensors (rmsnorm:
     :data:`RMS_CASES`, rows 8 and 512 at d 576, 8 at mamba2's d 1536 and
     3072, the training forward's 16,384 x 576, float32 within
     ``rtol=1e-5, atol=1e-6``, bfloat16 within one bfloat16 ulp; decode
     attention: 8 x 9 heads over 3 KV heads of 64,
     a 2048-token bfloat16 cache, lengths from the seed with a 0 and a
     2048, within one bfloat16 ulp, ``rtol=2**-7, atol=1e-4``, and zeros
     for the empty row; every row must fail that tolerance against the
     plain version given its length minus or plus one; the grid of the
     split kernel, from ``split_plan``, must give every SM two blocks),
     then timed like phase 5 beside their plain versions, their bounds
     and the PyTorch call that computes the same function (``F.rms_norm``;
     ``scaled_dot_product_attention`` with the length mask and
     ``enable_gqa=True``), which the port never calls; rmsnorm at 8 x 576
     and decode attention, and their library calls, again replayed from
     CUDA graphs, without the host's dispatch;
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
  9. ``ssd_scan``: its bfloat16 kernels' SASS must hold tensor-core
     instructions (``HMMA``); then against its plain version on the same
     CUDA tensors, at the served prefill's shape (1 x 512 tokens x 48
     heads x 64, state 128, one group), at (4, 2048) of the same, and with
     4 groups and a ragged s (1000), in bfloat16 and float32: y and the
     final state within ``SSD_F32_TOL`` (float32) and one bfloat16 ulp for
     a bfloat16 y, every case failing the state tolerance against the
     plain version given s - 1 steps; then timed like phase 5 beside the
     plain version's time and the bound (no single PyTorch call computes
     the scan, so no library time), with the CUDA launches a call makes
     and their blocks (``cuda_launches``: the library's own plan of its
     grids), and the served prefill's call
     replayed from a CUDA graph;
 10. ``flash_attention``: its bfloat16 kernel's SASS must hold
     tensor-core instructions (``HMMA``); then against its plain version,
     causal, at the training shape (8 x 9 heads over 3 KV heads x 2048 x
     64, bfloat16), at D 128 with GQA, with Sq < Sk and at a ragged
     length in float32: the output and lse within ``FLASH_F32_TOL``
     (float32) and one bfloat16 ulp for a bfloat16 output; then timed like
     phase 5 beside
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
 13. the host runtime (main path): (a) ``examples/opencl_runtime.py``'s
     steps up to its co-executor on the ``cuda`` device — 256
     work-items, local size 64, an out-of-order queue, write -> scale ->
     offset -> read through one ``Buffer`` — equal to ``host * 2 + 1``
     bitwise, with monotone event profiles; (b) the rmsnorm -> residual
     -> quantize chain (``core/examples.py``) over 16,384 x 576 float32
     elements, smollm-135m's activations of one training forward, in
     pooled context buffers on an in-order queue, with fusion off and
     with fusion at flush: ``q`` bitwise equal across the two modes, to
     the ``vector`` target on the card and to a numpy float32 oracle;
     ``dag_stats()`` one fused chain, two commands eliminated and the
     elided bytes; 1 ``cuda`` launch against 3; the intermediates ``y``
     and ``z`` never materialized, ``torch.cuda.memory_allocated()``
     grown by the four other buffers only; then ``CHAIN_ROUNDS`` rounds
     of 20 chains in each mode, each chain's stream span taken with
     CUDA events around enqueue ... ``finish()`` (L2 flushed before
     each; the span holds the host's hand-offs, so it is not the card's
     busy time) and on the host's clock, beside their bounds; (c) a
     read map of ``q`` equal to ``enqueue_read_buffer``, then a second
     one, whose staging comes from torch's pinned cache; a write map of
     a sub-buffer over the middle half of ``x``, written on the host,
     unmapped, and the chain run again, equal to the oracle on the new
     ``x``; a launch over a still-mapped buffer failing its event with
     ``MapError``; the map and unmap times beside the bare copies
     between the card and a pinned host tensor; (d) the fused run of
     (b) recorded under ``ctx.trace()``, exported under
     ``build/repro_torch/`` and valid (``validate_trace``), with one
     slice per command; then the fused kernel alone against the
     ``vector`` target on the same tensors, and the three unfused
     kernels on those tensors, each and back to back, all timed like
     phase 5; the host time a command is a chain's stream span less its
     kernels' time, over its commands;
 14. co-execution and the autotuner (main path), every result bitwise:
     (a) ``examples/opencl_runtime.py``'s end: the scale kernel's
     host-array launch split over ``ctx.platform.co_devices(2)``,
     static, equal to ``ctx.launch``; (b) phase 5's GEMM (2048^3) and
     stencil1d (1<<25, use_local 1) over two ``cuda`` devices of the
     card, in static, steal and adaptive mode twice each, the inputs in
     SharedBuffers kept across launches and the outputs in fresh ones
     that start as NaN wherever the launch writes (GEMM's C holds the
     answer in its even rows, so its merge takes the whole-buffer path;
     stencil1d's y takes the span-granular one): equal to one launch
     and to the oracle, the chunks covering every group, each output
     merged by its path, the read-only buffers moving on no launch
     after the first; wall ms beside one launch's
     (host arrays in, host tensors out) and its kernel's, the merge ms,
     groups and chunks per device, transfers, bytes each way and the
     merge's path; (c) ``benchmarks/bench_coexec.py``'s lopsided platform
     over the card — two throttled ``cuda`` devices at 1 ms a group and
     one at 8 ms, a 0.25 s stall armed before every timed launch —
     adaptive against the best all-positive static split, the ratio
     beside the benchmark's 1.5x gate; (d) the card's ``cuda`` device
     and the CPU's ``vector`` device, adaptive, over the scale kernel at
     1<<24 float32, five launches (weights, groups and bytes each way per
     launch), then a fresh executor warm-started from the persisted
     tuning table, whose first two launches must give the CPU a weight
     under 0.2 and fewer than half the groups; (e) every suite kernel at
     its full shape on the ``auto`` device: the first launch tunes (the
     ``vector`` and ``cuda`` candidates' us, both timed and neither
     failed, and the winner), the second and a new
     AutotunedKernel over the same table measure nothing, and the
     outputs equal the ``vector`` target and the oracle; ``x = x * s``
     enqueued on a queue of the ``auto`` device gives ``x * s`` once;
     (f) ROADMAP C.10's input (-1.0 times zeros and NaNs) over (b)'s and
     (d)'s pairs, each element equal to the single launch of the device
     that ran it;
 15. vml (main path): a kernel ``y = op(x)`` for each op Vecmathlib
     serves (exp, log, sin, cos, tanh, erf, sqrt, rsqrt), built with
     ``use_vml=True``, launched through ``Context.launch`` on the card
     over 1<<24 float32 from ``vml_inputs`` (±0, ±inf, NaN, denormals,
     the clamp thresholds, every quadrant of sin and cos, |x| > 88 for
     exp, log-uniform magnitudes); the ``cuda`` kernel must equal the
     ``vector`` target with ``use_vml=True`` on the card bitwise, NaNs
     included; the largest ulp distance from the same op's libm kernel
     (``use_vml=False``) and from torch's op on the card, over every
     input and over ``tests/test_vml.py``'s ranges where the result is at
     least 1e-6 in magnitude; then the vml kernel,
     the libm kernel and torch's op (the library call) timed like phase
     5, beside the bytes bound (8 B an element);
 16. the performance-portability scoreboard
     (``repro_torch.suite.scoreboard``): the ``card`` shape set (phase
     5's sizes) over ``vector``, ``cuda``, ``coexec2`` (two ``cuda``
     devices of the card) and ``auto``, every tuning configuration, and
     the ``ci`` set over ``loop``, ``vector`` and ``cuda`` with two
     configurations a space and one timed launch; the peaks calibrated on
     the card beside the data sheet's, the markdown matrix, each cell's
     device and wall time and both fractions; the ``bitwise`` and
     ``winner_beats_worst`` gates must hold; the reports land in
     ``build/repro_torch/phase16_scoreboard_{card,ci}.{json,md}``;
 17. the kernels line, then the card's name and power limit, then the
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
# phase 7: rmsnorm cases, (rows, d, x dtype, w dtype): a decode step's
# shape first (its time is the kernels line's, and it is replayed from a
# CUDA graph too), then the serving prefill's rows, mamba2's widths (the
# layer norm at 1536, the gated norm at 3072) and the training forward's
# 16,384 rows.  Float32 within rtol=1e-5, atol=1e-6 (the squares are
# summed in other orders); bfloat16 within one bfloat16 ulp
RMS_CASES = [(8, 576, "bfloat16", "bfloat16"), (8, 576, "bfloat16", "float32"),
             (8, 576, "float32", "float32"), (512, 576, "bfloat16", "bfloat16"),
             (512, 576, "float32", "float32"),
             (8, 1536, "bfloat16", "bfloat16"), (8, 3072, "bfloat16", "bfloat16"),
             (16384, 576, "bfloat16", "bfloat16")]
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
# phase 13: the host runtime.  The walk-through at examples/
# opencl_runtime.py's own size; the chain over smollm-135m's activations
# of one training forward (16,384 tokens x d 576, float32: 37.7 MB a
# buffer), timed over CHAIN_ROUNDS rounds of CHAIN_REPS chains in each
# mode
HOST_N, HOST_LSZ = 256, 64
CHAIN = ("rmsnorm_ew", "residual_add", "quantize")
CHAIN_N, CHAIN_LSZ = 16384 * 576, 256
CHAIN_SCALE = 16.0
CHAIN_REPS, CHAIN_ROUNDS = 20, 3
# phase 14: co-execution and the autotuner.  (b) splits phase 5's GEMM and
# stencil1d (use_local 1) over two cuda devices of the card; (c) is
# benchmarks/bench_coexec.py's lopsided platform (its size, per-group
# costs, stall and 1.5x gate) over the card; (d) the card and the host
# over 1<<24 float32 (64 MB) in HOSTCO_LAUNCHES launches; (e) the suite on
# the auto device at the full shapes (phase 4's); (f) ROADMAP C.10's
# input at C10_N elements
COEX_REAL = (0, 3)                  # REAL's gemm and stencil1d use_local 1
LOPS_N, LOPS_LSZ = 96 * 16, 16
LOPS_FAST_S, LOPS_SLOW_S, LOPS_STALL_S = 0.001, 0.008, 0.25
LOPS_SWEEP = [(1, 1, 1), (4, 4, 1), (8, 8, 1), (16, 16, 1),
              (47.5, 47.5, 1)]
LOPS_REPEATS, LOPS_GATE = 3, 1.5
HOSTCO_N, HOSTCO_LAUNCHES = 1 << 24, 5
# (d)'s warm start, the reference test's criteria: the CPU's weight and
# its share of the groups in each of the fresh executor's two launches
WARM_CPU_WEIGHT, WARM_CPU_GROUPS = 0.2, 0.5
C10_N = 1 << 20
# phase 15: vml over VML_N float32 in work-groups of VML_LSZ; the FP32
# operations an element takes in each function of csrc/vml.cuh (clamps,
# compares and selects counted as one each), for its bound
VML_N, VML_LSZ = 1 << 24, 256
VML_FLOPS = {"exp": 27, "log": 26, "sin": 21, "cos": 21, "tanh": 33,
             "erf": 45, "sqrt": 13, "rsqrt": 19}
# tests/test_vml.py's ranges, where vml is held to libm's accuracy
VML_RANGES = {"exp": (-80.0, 80.0), "log": (1e-30, 1e30),
              "sin": (-50.0, 50.0), "cos": (-50.0, 50.0),
              "tanh": (-20.0, 20.0), "erf": (-5.0, 5.0), "sqrt": (0.0, 1e30),
              "rsqrt": (1e-30, 1e30)}
VML_SOURCE = "src/repro_torch/csrc/vml.cuh"
# phase 16: the scoreboard at the card set (every configuration:
# SB_REPEATS timed launches on the card, then one through Context.launch;
# a cuda kernel's first launch, which loads its module, and the auto
# device's, which tunes, are warm-ups) and at the ci set (two
# configurations a space, one timed launch of each kind: the loop target
# steps work-items from the host, seconds a launch)
SB_REPEATS = 2
SB_LIMIT_S = 240.0


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sass_counts(lib, function=None):
    """Static counts of shared loads and stores, block barriers, FP32
    arithmetic and tensor-core instructions (``HMMA``: ``mma.sync``;
    ``HGMMA``: ``wgmma``) in a built library's SASS (``cuobjdump -sass``),
    over its kernels whose name contains ``function`` (all where None),
    or None where the tool is missing or fails."""
    from repro_torch.core.nvcc import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    try:
        r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                           text=True, timeout=120)
    except OSError:
        return None
    if r.returncode != 0:
        return None
    ops, name = [], ""
    for ln in r.stdout.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ", 1)[1].strip()
            continue
        if function is not None and function not in name:
            continue
        toks = ln.split("*/", 1)[1].split() if "*/" in ln else []
        if toks and toks[0].startswith("@"):
            toks = toks[1:]
        if toks:
            ops.append(toks[0])
    return {k: sum(1 for o in ops if o.split(".")[0] == k)
            for k in ("LDS", "STS", "BAR", "FFMA", "FADD", "FMUL", "HMMA",
                      "HGMMA")}


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


def graph_ms(torch, time_ms, fn):
    """``fn``'s time without its host dispatch: ``fn`` captured once in a
    CUDA graph (after three warm-up calls on a side stream), the graph's
    replays timed by ``time_ms`` (L2 flushed before each)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay)


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
        decode_attention, decode_attention_plain, split_plan)
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
    rms_err, rms_cases = 0.0, []
    for rows, d, xdt, wdt in RMS_CASES:
        xdt, wdt = getattr(torch, xdt), getattr(torch, wdt)
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
        case = {"rows": rows, "d": d, "x": str(xdt), "w": str(wdt), "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                "fraction_of_bound": bms / ms}
        if not rms_cases:
            # the decode step's call again, replayed from CUDA graphs: the
            # device's time alone, where the host's dispatch outlasts the
            # L2 flush
            case["graph_replay"] = {
                "ms": graph_ms(torch, time_ms, lambda: rmsnorm(x, w)),
                "library_ms": graph_ms(
                    torch, time_ms, lambda: F.rms_norm(x, (d,), wl, 1e-6))}
        rms_cases.append(case)
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
    n_split, kps = split_plan(B, Hkv, S)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert B * Hkv * n_split >= 2 * sms, \
        ("decode attention's grid gives the SMs fewer than two blocks each",
         n_split, sms)
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
    # the same two calls replayed from CUDA graphs: the device's time
    # alone, where the host's dispatch outlasts the L2 flush
    graph = {"ms": graph_ms(torch, time_ms,
                            lambda: decode_attention(q, kc, vc, lengths)),
             "library_ms": graph_ms(
                 torch, time_ms, lambda: F.scaled_dot_product_attention(
                     q4, kc, vc, attn_mask=mask, enable_gqa=True))}
    nbytes = 2 * Hkv * D * 2 * int(lens.sum()) + 2 * B * H * D * 2 + 4 * B
    bms = nbytes / PEAK_HBM_BYTES * 1e3
    emit(7, kernel="decode_attention", B=B, H=H, Hkv=Hkv, D=D, S=S,
         lengths=lens.tolist(), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
         graph_replay=graph, bound_ms=bms, fraction_of_bound=bms / ms,
         n_split=n_split,
         keys_per_split=kps, blocks=B * Hkv * n_split, combine_blocks=B * H,
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
    from repro_torch.kernels.ssd_scan import (KERNEL, cuda_launches, ssd_scan,
                                              ssd_scan_plain)
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

    # -- 9. ssd_scan against its plain version, then timed; the bfloat16
    # path's tensor-core instructions in the built library first
    mma_sass = sass_counts(KERNEL.lib_path, "mma_kernel")
    assert mma_sass is not None, "cuobjdump could not read the ssd library"
    assert mma_sass["HMMA"] + mma_sass["HGMMA"] > 0, \
        ("no tensor-core instruction in the bfloat16 ssd kernels", mma_sass)
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
            plan = cuda_launches(b, s, h, p, g, n, chunk, dtype)
            case = {"shape": [b, s, h, p], "g": g, "n": n, "chunk": chunk,
                    "dtype": str(dtype), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by,
                    "fraction_of_bound": bms / ms, "y_err": y_err,
                    "state_err": st_err,
                    "short_state_diff": float((st - short).abs().max()),
                    "cuda_launches_per_call": len(plan),
                    "blocks": dict(plan)}
            if not cases:
                # the served prefill's call again, replayed from a CUDA
                # graph: the device's time alone, without the host's
                # dispatch of its launches
                case["graph_ms"] = graph_ms(
                    torch, time_ms, lambda: ssd_scan(x, dt, A, B, C, chunk))
            if dtype == torch.bfloat16:
                # the device time of each of its kernels (L2 warm)
                case["profile"] = _profiled(
                    torch, lambda: ssd_scan(x, dt, A, B, C, chunk), 10)
            cases.append(case)
            del x, dt, B, C, y, st, py, pst, short
    emit(9, kernel="ssd_scan", cases=cases, max_abs_err_vs_plain=err,
         y_tol={"float32": SSD_F32_TOL, "bfloat16": SSD_Y_BF16_TOL},
         state_tol=SSD_F32_TOL, launches=launches["ssd_scan"],
         bf16_sass=mma_sass, library_ms=None)
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
    from repro_torch.kernels.flash_attention import (BLOCK_Q, KERNEL,
                                                     flash_attention,
                                                     flash_attention_plain)
    # the bfloat16 path's tensor-core instructions in the built library
    mma_sass = sass_counts(KERNEL.lib_path, "flash_attention_mma_kernel")
    assert mma_sass is not None, "cuobjdump could not read the flash library"
    tensor_core = mma_sass["HMMA"] + mma_sass["HGMMA"]
    assert tensor_core > 0, ("no tensor-core instruction in the bfloat16 "
                             "flash kernel", mma_sass)
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
                      "blocks": B * H * -(-Sq // BLOCK_Q[(dtype, D)])})
        del q, k, v, o, lse
    emit(10, kernel="flash_attention", cases=cases,
         bf16_sass=mma_sass, bf16_tensor_core_instructions=tensor_core,
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


def build_scale():
    """``examples/opencl_runtime.py``'s first kernel: x = x * s."""
    from repro_torch.core import KernelBuilder
    b = KernelBuilder("scale")
    x = b.arg_buffer("x", "float32")
    s = b.arg_scalar("s", "float32")
    g = b.global_id(0)
    x[g] = x[g] * s
    return b.finish()


def build_offset():
    """``examples/opencl_runtime.py``'s second kernel: x = x + o."""
    from repro_torch.core import KernelBuilder
    b = KernelBuilder("offset")
    x = b.arg_buffer("x", "float32")
    o = b.arg_scalar("o", "float32")
    g = b.global_id(0)
    x[g] = x[g] + o
    return b.finish()


def chain_kernels(chain_prog, bufs, inv_rms):
    """The chain's three kernels with their arguments set over ``bufs``."""
    k1, k2, k3 = (chain_prog.create_kernel(n) for n in CHAIN)
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=inv_rms)
    k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
    k3.set_args(z=bufs["z"], q=bufs["q"], scale=CHAIN_SCALE)
    return k1, k2, k3


def warm_fused_chain(ctx, device, chain_prog):
    """The chain enqueued over lazy pooled buffers on a queue that is not
    flushed yet: the queue stitches its pending chain into ``device``'s
    fused tier under the key its flush-time rewrite looks up
    (``pending_chain_spec``), so phase 1's wave builds the binary that
    phase 13 launches.  Returns the queue, its buffers and the spec; the
    caller finishes the queue after the wave."""
    bufs = {n: ctx.create_buffer(CHAIN_N, device=device) for n in "xwryzq"}
    queue = ctx.create_queue(device, fusion="flush")
    for k in chain_kernels(chain_prog, bufs, 1.0):
        queue.enqueue_nd_range(k, (CHAIN_N,), (CHAIN_LSZ,))
    return queue, bufs, queue.pending_chain_spec()


def chain_oracle(np, x, w, r, inv_rms):
    """The chain in numpy float32, op for op as the kernels compute it."""
    f = np.float32
    z = (x * w) * f(inv_rms) + r
    v = np.floor(z * f(CHAIN_SCALE) + f(0.5))
    return np.maximum(f(-127.0), np.minimum(f(127.0), v))


def host_runtime_phase(torch, np, time_ms, flush, ctx, cuda_dev, vec_dev,
                       host_prog, chain_prog, fused_spec, reset_counts):
    """Phase 13: the host runtime on the card (see the module docstring).
    Returns the kernels line's entry for the fused chain."""
    import threading
    from repro_torch.core.errors import MapError
    from repro_torch.core.nvcc import BUILD_DIR
    from repro_torch.runtime import create_sub_buffer, validate_trace

    # -- (a) examples/opencl_runtime.py up to its co-executor ---------------
    scale = host_prog.create_kernel("scale")
    offset = host_prog.create_kernel("offset")
    host = np.arange(HOST_N, dtype=np.float32)
    out = np.zeros(HOST_N, np.float32)
    buf = ctx.create_buffer(HOST_N, "float32", device=cuda_dev)
    scale.set_args(x=buf, s=2.0)
    offset.set_args(x=buf, o=1.0)
    q = ctx.create_queue(cuda_dev, out_of_order=True)
    reset_counts()
    e_w = q.enqueue_write_buffer(buf, host)
    e_s = q.enqueue_nd_range(scale, (HOST_N,), (HOST_LSZ,), wait_for=[e_w])
    e_o = q.enqueue_nd_range(offset, (HOST_N,), (HOST_LSZ,), wait_for=[e_s])
    e_r = q.enqueue_read_buffer(buf, out, wait_for=[e_o])
    q.finish()
    walk = {n: k.bind(cuda_dev, (HOST_LSZ,)).prog.launches
            for n, k in (("scale", scale), ("offset", offset))}
    assert walk == {"scale": 1, "offset": 1}, walk
    assert buf.data.is_cuda and q.stats["launches"] == 2
    expect = host * np.float32(2.0) + np.float32(1.0)
    assert out.tobytes() == expect.tobytes(), "walk-through result"
    evs = (e_w, e_s, e_o, e_r)
    for ev in evs:
        p = ev.profile
        assert p["queued_ns"] <= p["submit_ns"] <= p["start_ns"] \
            <= p["end_ns"], (ev.name, p)
    for a, b in zip(evs, evs[1:]):
        assert a.end_ns <= b.start_ns, (a.name, b.name)
    emit(13, part="walkthrough", work_items=HOST_N, local_size=HOST_LSZ,
         device=cuda_dev.info.name, launches=walk, bitwise=True,
         event_us={ev.name: (ev.end_ns - ev.start_ns) / 1e3 for ev in evs})
    buf.release()

    # -- (b) the chain at 16,384 x 576, fusion off and at flush -----------
    rng = np.random.default_rng(13)
    xh, wh, rh = (rng.standard_normal(CHAIN_N, dtype=np.float32)
                  for _ in range(3))
    inv_rms = float(np.float32(1.0 / np.sqrt(np.mean(xh.astype(np.float64)
                                                      ** 2))))
    want = chain_oracle(np, xh, wh, rh, inv_rms)
    nbytes = CHAIN_N * 4
    unfused = [chain_prog.create_kernel(n).bind(cuda_dev, (CHAIN_LSZ,)).prog
               for n in CHAIN]
    fused = fused_spec.program.binary_for(fused_spec.kernel_name,
                                          (CHAIN_LSZ,), device=cuda_dev)

    def run_chain(queue_dev, fusion):
        """Fresh pooled buffers on the card, the inputs written, the
        chain enqueued and ``q`` read back, on a new in-order queue."""
        bufs = {n: ctx.create_buffer(CHAIN_N, device=cuda_dev)
                for n in "xwryzq"}
        queue = ctx.create_queue(queue_dev, fusion=fusion)
        for n, h in zip("xwr", (xh, wh, rh)):
            queue.enqueue_write_buffer(bufs[n], h)
        kernels = chain_kernels(chain_prog, bufs, inv_rms)
        for k in kernels:
            queue.enqueue_nd_range(k, (CHAIN_N,), (CHAIN_LSZ,))
        got = np.zeros(CHAIN_N, np.float32)
        queue.enqueue_read_buffer(bufs["q"], got)
        queue.finish()
        return got, bufs, queue, kernels

    reset_counts()
    q_off, bufs_off, queue_off, kern_off = run_chain(cuda_dev, "off")
    off_launches = [p.launches for p in unfused] + [fused.prog.launches]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(cuda_dev.torch_device)
    reset_counts()
    with ctx.trace() as tr:
        q_on, bufs_on, queue_on, kern_on = run_chain(cuda_dev, "flush")
    on_launches = [p.launches for p in unfused] + [fused.prog.launches]
    grown = torch.cuda.memory_allocated(cuda_dev.torch_device) - mem0
    q_vec, bufs_vec, _, _ = run_chain(vec_dev, "off")
    assert off_launches == [1, 1, 1, 0], off_launches
    assert on_launches == [0, 0, 0, 1], on_launches
    stats = queue_on.dag_stats()
    assert stats == {"mode": "flush", "fused_chains": 1,
                     "commands_eliminated": 2,
                     "bytes_elided": 2 * 2 * nbytes}, stats
    assert queue_off.dag_stats()["fused_chains"] == 0
    assert queue_on.stats["launches"] == 1
    assert queue_off.stats["launches"] == 3
    assert not bufs_on["y"].materialized and not bufs_on["z"].materialized
    assert grown <= 4 * nbytes, ("y or z allocated", grown)
    for name, got in (("unfused", q_off), ("vector", q_vec),
                      ("numpy", want)):
        assert q_on.tobytes() == got.tobytes(), ("fused vs", name)
    for b in bufs_vec.values():
        b.release()

    def time_chain(queue, kernels):
        for k in kernels:                       # warm-up chain
            queue.enqueue_nd_range(k, (CHAIN_N,), (CHAIN_LSZ,))
        queue.finish()
        marks, walls = [], []
        for _ in range(CHAIN_REPS):
            flush.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            t0 = time.perf_counter()
            for k in kernels:
                queue.enqueue_nd_range(k, (CHAIN_N,), (CHAIN_LSZ,))
            queue.finish()
            walls.append((time.perf_counter() - t0) * 1e3)
            e.record()
            marks.append((s, e))
        torch.cuda.synchronize()
        dev_ms = sorted(s.elapsed_time(e) for s, e in marks)
        return dev_ms[len(dev_ms) // 2], sorted(walls)[len(walls) // 2]

    span_ms = {"off": [], "flush": []}
    wall_ms = {"off": [], "flush": []}
    for _ in range(CHAIN_ROUNDS):             # the modes take turns
        for mode, queue, kernels in (("off", queue_off, kern_off),
                                     ("flush", queue_on, kern_on)):
            span, wall = time_chain(queue, kernels)
            span_ms[mode].append(span)
            wall_ms[mode].append(wall)
    assert queue_on.dag_stats()["fused_chains"] \
        == 1 + CHAIN_ROUNDS * (1 + CHAIN_REPS)
    assert not bufs_on["y"].materialized and not bufs_on["z"].materialized
    emit(13, part="chain", n=CHAIN_N, local_size=CHAIN_LSZ,
         buffer_mb=nbytes / 1e6, bitwise=["unfused", "vector", "numpy"],
         dag_stats=stats, launches={"off": off_launches[:3],
                                    "flush": on_launches[3]},
         y_z_materialized=False, memory_grown_mb=grown / 1e6,
         stream_span_ms=span_ms, wall_ms=wall_ms,
         bound_ms={"off": 8 * nbytes / PEAK_HBM_BYTES * 1e3,
                   "flush": 4 * nbytes / PEAK_HBM_BYTES * 1e3})
    for b in bufs_off.values():
        b.release()
    torch.cuda.empty_cache()

    # -- (c) maps at that size --------------------------------------------
    def map_ms(region):
        return (region.event.end_ns - region.event.start_ns) / 1e6

    def unmap_ms(region):
        return (region.unmap_event.end_ns
                - region.unmap_event.start_ns) / 1e6

    read_maps = []                 # the second one's staging is cached
    for _ in range(2):
        read_map = queue_on.enqueue_map_buffer(bufs_on["q"], "r")
        assert read_map.get().tobytes() == q_on.tobytes(), "read map"
        queue_on.enqueue_unmap_buffer(read_map)
        queue_on.finish()
        read_maps.append(read_map)
    lo, half = CHAIN_N // 4, CHAIN_N // 2
    x_new = xh.copy()
    x_new[lo:lo + half] = rng.standard_normal(half, dtype=np.float32)
    mid = create_sub_buffer(bufs_on["x"], lo * 4, half * 4)
    write_map = queue_on.enqueue_map_buffer(mid, "w")
    write_map.get()[...] = x_new[lo:lo + half]
    queue_on.enqueue_unmap_buffer(write_map)
    for k in kern_on:
        queue_on.enqueue_nd_range(k, (CHAIN_N,), (CHAIN_LSZ,))
    q_new = np.zeros(CHAIN_N, np.float32)
    queue_on.enqueue_read_buffer(bufs_on["q"], q_new)
    queue_on.finish()
    assert q_new.tobytes() == chain_oracle(np, x_new, wh, rh,
                                           inv_rms).tobytes(), "after map"
    held = queue_on.enqueue_map_buffer(bufs_on["x"], "r")
    held.get()
    refused = ctx.create_queue(cuda_dev, fusion="off")
    bad = refused.enqueue_nd_range(kern_on[0], (CHAIN_N,), (CHAIN_LSZ,))
    failed = threading.Event()
    bad.add_callback(lambda ev: failed.set())
    refused.flush()
    assert failed.wait(60) and isinstance(bad.error, MapError), bad.error
    queue_on.enqueue_unmap_buffer(held)
    queue_on.finish()
    pinned = torch.empty(CHAIN_N, pin_memory=True)
    q_dev, x_mid = bufs_on["q"].data, mid.data
    copy_ms = {
        "d2h": time_ms(lambda: pinned.copy_(q_dev, non_blocking=True),
                       reps=5, warmup=1),
        "h2d_half": time_ms(lambda: x_mid.copy_(pinned[:half],
                                                non_blocking=True),
                            reps=5, warmup=1)}
    del pinned, q_dev, x_mid
    emit(13, part="maps", read_map_equal=True, write_map_then_chain=True,
         launch_over_map="MapError",
         ms={"map_r": map_ms(read_maps[0]), "unmap_r": unmap_ms(read_maps[0]),
             "map_r_again": map_ms(read_maps[1]),
             "unmap_r_again": unmap_ms(read_maps[1]),
             "map_w_half": map_ms(write_map),
             "unmap_w_half": unmap_ms(write_map)},
         copy_ms=copy_ms, bytes={"map_r": nbytes, "map_w_half": half * 4})

    # -- (d) the trace of (b)'s fused run ---------------------------------
    events = tr.trace_events()
    counts = validate_trace(events)
    slices = sorted(e["name"] for e in events if e["ph"] == "X")
    expect_slices = sorted(["write"] * 3 + [f"ndrange:{n}" for n in CHAIN]
                           + ["fused:" + "+".join(CHAIN), "read"])
    assert slices == expect_slices, slices
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = BUILD_DIR / "phase13_trace.json"
    tr.export(str(trace_path))
    emit(13, part="trace", path=os.path.relpath(trace_path, ROOT),
         counts=counts, slices=len(slices))

    # -- the fused kernel alone, beside the vector target ---------------------
    fb, fs = fused_spec.bind_launch(
        [{"x": bufs_on["x"], "w": bufs_on["w"], "y": bufs_on["y"]},
         {"y": bufs_on["y"], "r": bufs_on["r"], "z": bufs_on["z"]},
         {"z": bufs_on["z"], "q": bufs_on["q"]}],
        [{"inv_rms": inv_rms}, {}, {"scale": CHAIN_SCALE}])
    dbufs = {n: b.data for n, b in fb.items()}
    pbufs = {n: t.clone() for n, t in dbufs.items()}
    plain = fused_spec.program.binary_for(fused_spec.kernel_name,
                                          (CHAIN_LSZ,), device=vec_dev)
    fused.launch_ndrange(dbufs, (CHAIN_N,), fs)
    plain.launch_ndrange(pbufs, (CHAIN_N,), fs)
    err = float((dbufs["k2_q"] - pbufs["k2_q"]).abs().max())
    assert err == 0.0, ("fused chain", "cuda vs vector", err)
    ms = time_ms(lambda: fused.launch_ndrange(dbufs, (CHAIN_N,), fs))
    plain_ms = time_ms(lambda: plain.launch_ndrange(pbufs, (CHAIN_N,), fs),
                       reps=3, warmup=1)
    bms, by = bound(8.0 * CHAIN_N, 4 * nbytes)

    # -- the three unfused kernels on the same inputs, each and in turn -------
    ut = {n: bufs_on[n].data for n in "xwr"}
    ut.update({n: torch.empty_like(ut["x"]) for n in "yzq"})
    ubins = [chain_prog.create_kernel(n).bind(cuda_dev, (CHAIN_LSZ,))
             for n in CHAIN]
    calls = [(ubins[0], {n: ut[n] for n in "xwy"}, {"inv_rms": inv_rms}),
             (ubins[1], {n: ut[n] for n in "yrz"}, {}),
             (ubins[2], {n: ut[n] for n in "zq"}, {"scale": CHAIN_SCALE})]

    def unfused_chain():
        for b, bufs, sc in calls:
            b.launch_ndrange(bufs, (CHAIN_N,), sc)

    unfused_chain()
    assert torch.equal(ut["q"], dbufs["k2_q"]), "unfused vs fused kernels"
    kernel_ms = {
        "flush": ms,
        "off": time_ms(unfused_chain),
        "off_each": {n: time_ms(lambda b=b, bufs=bufs, sc=sc:
                                b.launch_ndrange(bufs, (CHAIN_N,), sc))
                     for n, (b, bufs, sc) in zip(CHAIN, calls)}}
    emit(13, part="kernels", kernel_ms=kernel_ms,
         host_ms_a_command={
             "off": [(t - kernel_ms["off"]) / len(CHAIN)
                     for t in span_ms["off"]],
             "flush": [t - ms for t in span_ms["flush"]]})
    del ut, calls
    assert not bufs_on["y"].materialized and not bufs_on["z"].materialized
    for b in bufs_on.values():
        b.release()
    del dbufs, pbufs
    torch.cuda.empty_cache()
    return {"name": "cuda_target/fused_chain", "launches": on_launches[3],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


# ---------------------------------------------------------------------------
# phase 14: co-execution and the autotuner
# ---------------------------------------------------------------------------

def build_coexec_scale():
    """``benchmarks/bench_coexec.py``'s kernel: y = x * 2 + g."""
    from repro_torch.core import KernelBuilder
    b = KernelBuilder("coexec_scale")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    g = b.global_id(0)
    y[g] = x[g] * 2.0 + g
    return b.finish()


def card_programs(kernel, devices, lsz):
    """The ``cuda`` programs ``kernel`` runs on ``devices`` (those of
    driver cuda), whose ``launches`` count its kernel launches."""
    return [kernel.bind(d, lsz).prog for d in devices
            if d.info.driver == "cuda"]


def zero_counts(progs):
    for p in progs:
        p.launches = 0


def transfers(stats, names):
    """Transfer commands of a co-executed launch, per buffer."""
    return {n: sum(1 for e in stats.transfer_events
                   if e.name.split("->")[0] == f"migrate:{n}")
            for n in names}


def covered(stats):
    """The union of a co-executed launch's chunk spans, as sorted
    disjoint group ranges: [(0, n_groups)] when no group was left out."""
    out = []
    for lo, hi in sorted((lo, hi) for _, lo, hi in stats.chunk_spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def output_fill(np, name, shape, expected):
    """The canonical value a co-executed launch's outputs start from in
    (b): NaN wherever the launch must write, so a chunk that is dropped
    or runs over the wrong groups leaves NaN for the comparison to see.
    GEMM's C holds the answer in its even rows, so each device changes
    only odd rows, far more runs than span bookkeeping keeps, and the
    merge takes the whole-buffer path; stencil1d's y is NaN throughout,
    so each device writes a few contiguous spans and the merge takes the
    span-granular path.  Returns the fills and the path each output's
    merge must take."""
    if name == "gemm":
        c = expected["C"].reshape(shape["m"], shape["n"]).copy()
        c[1::2] = np.nan
        return {"C": c.reshape(-1)}, {"C": "whole"}
    return ({o: np.full_like(v, np.nan) for o, v in expected.items()},
            {o: "spans" for o in expected})


def coexec_row(stats, wall_s, progs):
    return {"wall_ms": wall_s * 1e3, "merge_ms": stats.merge_s * 1e3,
            "groups_per_device": stats.groups_per_device,
            "chunks_per_device": stats.chunks_per_device,
            "steals_per_device": stats.steals_per_device,
            "migrations": stats.migrations,
            "partial_migrations": stats.partial_migrations,
            "bytes_to_device": stats.bytes_to_device,
            "bytes_to_host": stats.bytes_to_host,
            "merge_paths": stats.merge_paths,
            "launches": sum(p.launches for p in progs)}


def coexec_two_devices(torch, np, time_ms, ctx, card_dev, real_runs, drv,
                       sync):
    """(b): phase 5's GEMM and stencil1d split over two devices of the
    card in each mode, twice, with the inputs in SharedBuffers kept
    across launches and each launch's outputs in fresh ones (see
    ``output_fill``)."""
    from repro_torch.core import TuningTable
    from repro_torch.suite.scoreboard import expected_outputs
    devs = ctx.platform.co_devices(2, driver=drv)
    co = ctx.create_co_executor(devs, tuning_table=TuningTable())
    for idx in COEX_REAL:
        name, sk, shape, params, prog = real_runs[idx]
        inputs = sk.make_inputs(shape, params)
        expected = expected_outputs(sk, inputs, shape, params)
        gsz, lsz = sk.launch_dims(shape, params)
        k = prog.create_kernel().set_args(**inputs)
        sync()
        t0 = time.perf_counter()
        got = ctx.launch(k, gsz, lsz, device=card_dev)
        single = {o: got[o].cpu().numpy() for o in sk.outputs}
        single_wall_s = time.perf_counter() - t0
        for o in sk.outputs:
            assert single[o].tobytes() == expected[o].tobytes(), (name, o)
        binary = k.bind(card_dev, lsz)
        dbufs = {n: v.reshape(-1) for n, v in got.items()}
        kernel_ms = time_ms(lambda: binary.launch_ndrange(dbufs, gsz),
                            reps=5, warmup=1)
        read_only = [n for n in inputs if n not in sk.outputs]
        shared = {n: co.shared_buffer(inputs[n], n) for n in read_only}
        kc = prog.create_kernel().set_args(**shared)
        progs = card_programs(kc, devs, lsz)
        fills, paths = output_fill(np, name, shape, single)
        rows = []
        for mode in ("static", "steal", "adaptive"):
            for rep in (1, 2):
                outs = {o: co.shared_buffer(fills[o], o) for o in sk.outputs}
                kc.set_args(**outs)
                zero_counts(progs)
                t0 = time.perf_counter()
                out = co.launch(kc, gsz, lsz, mode=mode)
                wall_s = time.perf_counter() - t0
                st = co.last_stats
                co.finish()
                for o in sk.outputs:
                    assert out[o].numpy().tobytes() == single[o].tobytes(), \
                        (name, mode, o, "co-executed vs one launch")
                assert covered(st) == [(0, st.n_groups)], \
                    (name, mode, "chunks left groups out", covered(st))
                assert {o: st.merge_paths[o] for o in sk.outputs} == paths, \
                    (name, mode, st.merge_paths)
                moved = transfers(st, inputs)
                if rows:
                    assert not any(moved[n] for n in read_only), \
                        (name, mode, "a read-only buffer moved", moved)
                assert not progs or sum(p.launches for p in progs) > 0
                rows.append({"mode": mode, "launch": rep,
                             "transfers": moved,
                             **coexec_row(st, wall_s, progs)})
                for sb in outs.values():
                    sb.release()
        for sb in shared.values():
            sb.release()
        emit(14, part="two_devices", kernel=name, shape=shape,
             params=params, devices=[d.info.name for d in devs],
             driver=drv, bitwise=True, covered=True, merge_paths=paths,
             single_wall_ms=single_wall_s * 1e3,
             single_kernel_ms=kernel_ms, read_only=read_only, runs=rows)
        del got, dbufs, shared
        if card_dev.torch_device.type == "cuda":
            torch.cuda.empty_cache()
    return co


def coexec_lopsided(np, ctx, card_dev, drv):
    """(c): bench_coexec.py's lopsided platform over the card: two fast
    devices and one at 8x their cost per group, stalled before every
    timed launch; adaptive against the best all-positive static split."""
    import dataclasses as dc
    from repro_torch.core import TuningTable
    from repro_torch.runtime import Context, ThrottledDevice

    def platform():
        costs = ((LOPS_FAST_S, "fast"), (LOPS_FAST_S, "fast"),
                 (LOPS_SLOW_S, "slow"))
        devs = [ThrottledDevice(
            dc.replace(card_dev.info, name=f"lops-{cls}-{i}", driver=drv),
            card_dev.torch_device, seconds_per_group=s, coexec_class=cls,
            window_chunks=False) for i, (s, cls) in enumerate(costs)]
        lctx = Context(devices=devs, platform=ctx.platform)
        k = lctx.create_program(build_coexec_scale).create_kernel()
        k.set_args(x=np.arange(LOPS_N, dtype=np.float32),
                   y=np.zeros(LOPS_N, np.float32))
        return devs, lctx, k

    devs, lctx, k = platform()
    ref = ctx.launch(k, (LOPS_N,), (LOPS_LSZ,), device=card_dev)
    ref = ref["y"].cpu().numpy().tobytes()

    def timed(co, k, slow, mode, weights=None):
        # each timed launch starts on an idle platform: a launch waits for
        # the last one's stragglers, and that wait is not this launch's
        co.finish()
        slow.stall(LOPS_STALL_S)
        t0 = time.perf_counter()
        out = co.launch(k, (LOPS_N,), (LOPS_LSZ,), mode=mode,
                        weights=weights)
        wall_s = time.perf_counter() - t0
        assert out["y"].numpy().tobytes() == ref, (mode, weights)
        return wall_s

    co = lctx.create_co_executor(devs, tuning_table=TuningTable())
    progs = card_programs(k, devs, (LOPS_LSZ,))
    co.launch(k, (LOPS_N,), (LOPS_LSZ,), mode="static")
    zero_counts(progs)
    sweep = {"/".join(map(str, w)): min(
        timed(co, k, devs[2], "static", list(w))
        for _ in range(LOPS_REPEATS)) for w in LOPS_SWEEP}
    static_launches = sum(p.launches for p in progs)
    co.finish()
    best = min(sweep, key=sweep.get)

    devs, lctx, k = platform()
    table = TuningTable()
    co = lctx.create_co_executor(devs, tuning_table=table)
    progs = card_programs(k, devs, (LOPS_LSZ,))
    co.launch(k, (LOPS_N,), (LOPS_LSZ,), mode="static")
    for _ in range(3):
        co.launch(k, (LOPS_N,), (LOPS_LSZ,), mode="adaptive")
    zero_counts(progs)
    adaptive_s = min(timed(co, k, devs[2], "adaptive")
                     for _ in range(LOPS_REPEATS))
    st = co.last_stats
    co.finish()
    emit(14, part="lopsided", n=LOPS_N, local_size=LOPS_LSZ,
         seconds_per_group={"fast": LOPS_FAST_S, "slow": LOPS_SLOW_S},
         stall_s=LOPS_STALL_S, bitwise=True,
         static_sweep_ms={w: s * 1e3 for w, s in sweep.items()},
         best_static=best, best_static_ms=sweep[best] * 1e3,
         adaptive_ms=adaptive_s * 1e3,
         speedup=sweep[best] / adaptive_s, reference_gate=LOPS_GATE,
         weights=st.weights, groups_per_device=st.groups_per_device,
         steals_per_device=st.steals_per_device,
         launches={"static": static_launches,
                   "adaptive": sum(p.launches for p in progs)})


def coexec_card_and_host(np, ctx, card_dev, host_prog):
    """(d): the card and the CPU's vector device, adaptive, over the
    example's scale kernel at HOSTCO_N float32, then a fresh executor
    warm-started from the persisted tuning table."""
    from repro_torch.core import TuningTable
    from repro_torch.runtime import Context, Platform
    cpu_vec = Platform(torch_device="cpu").get_devices("vector")[0]
    pair = [card_dev, cpu_vec]
    hctx = Context(devices=pair, platform=ctx.platform)
    x0 = np.random.default_rng(14).standard_normal(HOSTCO_N,
                                                   dtype=np.float32)
    k = host_prog.create_kernel("scale").set_args(x=x0, s=2.0)
    single = ctx.launch(k, (HOSTCO_N,), (HOST_LSZ,), device=card_dev)
    single = single["x"].cpu().numpy().tobytes()
    progs = card_programs(k, pair, (HOST_LSZ,))
    table = TuningTable()
    n_groups = HOSTCO_N // HOST_LSZ

    def run(co, count):
        rows = []
        for i in range(count):
            zero_counts(progs)
            t0 = time.perf_counter()
            out = co.launch(k, (HOSTCO_N,), (HOST_LSZ,), mode="adaptive")
            wall_s = time.perf_counter() - t0
            assert out["x"].numpy().tobytes() == single, ("launch", i)
            st = co.last_stats
            assert covered(st) == [(0, n_groups)], ("launch", i)
            rows.append({"launch": i + 1, "weights": st.weights,
                         **coexec_row(st, wall_s, progs)})
        co.finish()
        return rows

    cold = run(hctx.create_co_executor(pair, tuning_table=table),
               HOSTCO_LAUNCHES)
    warm = run(hctx.create_co_executor(pair, tuning_table=table), 2)
    cpu = cpu_vec.info.name
    for row in warm:
        assert row["weights"][cpu] < WARM_CPU_WEIGHT, \
            ("warm start", row["weights"])
        assert row["groups_per_device"].get(cpu, 0) \
            < WARM_CPU_GROUPS * n_groups, row
    assert not progs or all(r["launches"] > 0 for r in cold + warm)
    emit(14, part="card_and_host", n=HOSTCO_N, local_size=HOST_LSZ,
         devices=[d.info.name for d in pair], bitwise=True,
         n_groups=n_groups, cold=cold, warm_start=warm,
         persisted=table.get_coexec(TuningTable.make_coexec_key(
             k.ir_hash, ["cuda", "vector"])))
    return hctx, pair


def coexec_auto(np, ctx, vec_dev, host_prog, auto_runs):
    """(e): the suite on the auto device: the first launch of a shape
    tunes, the second and a new AutotunedKernel over the same table
    measure nothing; a queue launch of x = x * s runs once, in place."""
    from repro_torch.core import TuningTable, set_default_table
    from repro_torch.core.api import _compile_kernel
    from repro_torch.core.nvcc import BUILD_DIR
    auto = ctx.platform.get_devices("auto")[0]
    path = BUILD_DIR / "phase14_tuning.json"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    table = TuningTable(str(path))
    set_default_table(table)
    rows = []
    try:
        for name, sk, shape, params, prog in auto_runs:
            inputs = sk.make_inputs(shape, params)
            expected = sk.oracle(inputs, shape, params)
            gsz, lsz = sk.launch_dims(shape, params)
            k = prog.create_kernel().set_args(**inputs)
            decisions = [auto.cache_stats()["tune_decisions"]]
            t0 = time.perf_counter()
            got = ctx.launch(k, gsz, lsz, device=auto)
            tune_s = time.perf_counter() - t0
            decisions.append(auto.cache_stats()["tune_decisions"])
            again = ctx.launch(k, gsz, lsz, device=auto)
            decisions.append(auto.cache_stats()["tune_decisions"])
            binary = k.bind(auto, lsz)
            fresh = _compile_kernel(prog.builder(k.name), lsz, target="auto",
                                    cache=auto.compile_cache,
                                    device_key=auto.info.name)
            new = fresh(inputs, gsz, device=auto.torch_device)
            decisions.append(auto.cache_stats()["tune_decisions"])
            assert decisions[1:] == [decisions[0] + 1] * 3, (name,
                                                              decisions)
            assert fresh.last_winner == binary.last_winner
            ref = ctx.launch(k, gsz, lsz, device=vec_dev)
            for o in sk.outputs:
                g = got[o].cpu().numpy().tobytes()
                assert g == again[o].cpu().numpy().tobytes() \
                    == new[o].cpu().numpy().tobytes() \
                    == ref[o].cpu().numpy().tobytes() \
                    == expected[o].tobytes(), (name, o)
            key = TuningTable.make_key(
                prog.ir_hash(k.name), lsz, gsz,
                sorted(binary.options.items()), device=auto.info.name)
            ent = json.loads(path.read_text())["winners"][key]
            # the card's kernel was timed and nothing failed: no plain
            # candidate won for want of it
            assert ent.get("failed", {}) == {}, (name, ent)
            assert set(ent["timings_us"]) == {"vector", "cuda"}, (name, ent)
            rows.append({"kernel": name, "params": params, "shape": shape,
                         "timings_us": ent["timings_us"],
                         "winner": ent["target"],
                         "failed": ent.get("failed", {}),
                         "tune_s": tune_s})
        host = np.arange(HOST_N, dtype=np.float32) - 100.0
        buf = ctx.create_buffer(HOST_N, device=auto)
        scale = host_prog.create_kernel("scale").set_args(x=buf, s=3.0)
        q = ctx.create_queue(auto)
        out = np.zeros(HOST_N, np.float32)
        q.enqueue_write_buffer(buf, host)
        q.enqueue_nd_range(scale, (HOST_N,), (HOST_LSZ,))
        q.enqueue_read_buffer(buf, out)
        q.finish()
        assert out.tobytes() == (host * np.float32(3.0)).tobytes(), \
            "auto queue launch applied more than once"
        buf.release()
    finally:
        set_default_table(None)
    emit(14, part="auto", device=auto.info.name, kernels=rows,
         table_entries=len(table), queue_once_bitwise=True,
         queue_winner=scale.bind(auto, (HOST_LSZ,)).last_winner)


def coexec_c10(np, host_prog, pairs):
    """(f): ROADMAP C.10's input — -1.0 times zeros and NaNs — over each
    pair of (context, executor): each element equal to the single launch
    of the device that ran it (the sign flips of the zeros merged, as the
    reference's ``!=`` merge does not)."""
    x = np.zeros(C10_N, np.float32)
    x[::3] = np.nan
    k = host_prog.create_kernel("scale").set_args(x=x, s=-1.0)
    rows = []
    for label, pctx, co in pairs:
        singles = {d: pctx.launch(k, (C10_N,), (HOST_LSZ,), device=d)["x"]
                   .cpu().numpy() for d in co.devices}
        merged = co.launch(k.clone(), (C10_N,), (HOST_LSZ,),
                           mode="static")["x"].numpy()
        co.finish()
        L = C10_N // len(co.devices)
        want = np.concatenate([singles[d][i * L:(i + 1) * L]
                               for i, d in enumerate(co.devices)])
        assert merged.tobytes() == want.tobytes(), (label, "C.10")
        first = singles[co.devices[0]]
        rows.append({
            "pair": label, "devices": [d.info.name for d in co.devices],
            "bitwise": True,
            "neg_zeros": int(np.sum((merged.view(np.uint32)
                                     == 0x80000000))),
            "nan_bits": sorted({f"{b:#010x}" for b in
                                merged.view(np.uint32)[::3].tolist()}),
            "devices_agree": all(v.tobytes() == first.tobytes()
                                 for v in singles.values())})
    emit(14, part="c10", n=C10_N, runs=rows)


def coexec_phase(torch, np, time_ms, ctx, card_dev, vec_dev, host_prog,
                 real_runs, auto_runs, drv="cuda"):
    """Phase 14: co-execution and the autotuner on the card (see the
    module docstring).  ``drv`` is the driver of the card's co-devices."""
    from repro_torch.core import TuningTable

    def sync():
        if card_dev.torch_device.type == "cuda":
            torch.cuda.synchronize()

    # -- (a) examples/opencl_runtime.py:83-94 ------------------------------
    host = np.arange(HOST_N, dtype=np.float32)
    k_host = host_prog.create_kernel("scale").set_args(x=host.copy(), s=2.0)
    single = ctx.launch(k_host, (HOST_N,), (HOST_LSZ,))["x"].cpu().numpy()
    devs = ctx.platform.co_devices(2)
    co = ctx.create_co_executor(devs, tuning_table=TuningTable())
    merged = co.launch(k_host.clone(), (HOST_N,), (HOST_LSZ,),
                       mode="static")
    st = co.last_stats
    co.finish()
    assert merged["x"].numpy().tobytes() == single.tobytes(), \
        "walk-through's co-execution"
    emit(14, part="walkthrough_end", devices=[d.info.name for d in devs],
         driver=devs[0].info.driver, single_device=ctx.devices[0].info.name,
         bitwise=True, groups_per_device=st.groups_per_device,
         migrations=st.migrations)

    two = coexec_two_devices(torch, np, time_ms, ctx, card_dev, real_runs,
                             drv, sync)
    coexec_lopsided(np, ctx, card_dev, drv)
    hctx, pair = coexec_card_and_host(np, ctx, card_dev, host_prog)
    coexec_auto(np, ctx, vec_dev, host_prog, auto_runs)
    coexec_c10(np, host_prog,
               [("two_devices", ctx, two),
                ("card_and_host", hctx, hctx.create_co_executor(pair))])


# ---------------------------------------------------------------------------
# phase 15: vml on the card
# ---------------------------------------------------------------------------

def vml_programs(ctx):
    """{op: (use_vml=True program, use_vml=False program)} of the kernel
    ``y = op(x)`` for each op Vecmathlib serves."""
    import functools
    from repro_torch.core import KernelBuilder
    from repro_torch.core.cases import VML_OPS, build_unary
    return {op: tuple(ctx.create_program(
        functools.partial(build_unary, KernelBuilder, op),
        use_vml=v).build() for v in (True, False)) for op in VML_OPS}


def ulp_distance(torch, a, b):
    """Elementwise distance of two float32 tensors in units in the last
    place (their bit patterns on one ordered integer line); 0 where
    either is NaN."""
    def ordered(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    nan = torch.isnan(a) | torch.isnan(b)
    return torch.where(nan, torch.zeros_like(a, dtype=torch.int64),
                       (ordered(a) - ordered(b)).abs())


def vml_phase(torch, np, time_ms, ctx, cuda_dev, vec_dev, vml_progs,
              reset_counts):
    """Phase 15 (main path): each op's use_vml=True kernel through
    Context.launch on the card, held bitwise against the vector target
    with use_vml=True there, its ulp distance from libm's kernel and
    torch's op, and the three timed.  Returns the kernels line's
    entries."""
    from repro_torch.core.cases import vml_inputs
    dev = cuda_dev.torch_device
    x = vml_inputs(np.random.default_rng(15), VML_N)
    zeros = np.zeros(VML_N, np.float32)
    kernels = {op: tuple(p.create_kernel().set_args(x=x, y=zeros)
                         for p in pair) for op, pair in vml_progs.items()}
    reset_counts()
    outs = {op: ctx.launch(kv, (VML_N,), (VML_LSZ,))["y"]
            for op, (kv, _) in kernels.items()}
    torch.cuda.synchronize()
    launches = {op: kv.bind(cuda_dev, (VML_LSZ,)).prog.launches
                for op, (kv, _) in kernels.items()}
    xd = torch.tensor(x, device=dev)
    entries = []
    for op, (kv, kl) in kernels.items():
        assert launches[op] > 0, (op, "not launched on the main path")
        got = outs[op]
        plain = ctx.launch(kv, (VML_N,), (VML_LSZ,), device=vec_dev)["y"]
        bad = got.view(torch.int32) != plain.view(torch.int32)
        n_bad = int(bad.sum())
        assert n_bad == 0, (op, "cuda vs vector, use_vml=True", n_bad,
                            x[bad.cpu().numpy()][:4].tolist())
        libm = ctx.launch(kl, (VML_N,), (VML_LSZ,))["y"]
        lib_fn = torch.rsqrt if op == "rsqrt" else getattr(torch, op)
        lo, hi = VML_RANGES[op]
        ulps = {}
        for other, want in (("libm", libm), ("torch", lib_fn(xd))):
            d = ulp_distance(torch, got, want)
            # relative accuracy: where the result is at least 1e-6 (near
            # zero vml is held to an absolute tolerance instead)
            inside = (xd >= lo) & (xd <= hi) & (want.abs() >= 1e-6)
            ulps[other] = {"max_ulp": int(d.max()),
                           "max_ulp_in_range": int(d[inside].max()),
                           "nan_differs": int((torch.isnan(got)
                                               != torch.isnan(want)).sum())}
        bufs = {"x": xd, "y": torch.zeros(VML_N, device=dev)}
        bv = kv.bind(cuda_dev, (VML_LSZ,))
        bl = kl.bind(cuda_dev, (VML_LSZ,))
        pv = kv.bind(vec_dev, (VML_LSZ,))
        ms = time_ms(lambda: bv.launch_ndrange(bufs, (VML_N,)))
        libm_ms = time_ms(lambda: bl.launch_ndrange(bufs, (VML_N,)))
        lib_ms = time_ms(lambda: lib_fn(xd))
        plain_ms = time_ms(lambda: pv.launch_ndrange(bufs, (VML_N,)),
                           reps=3, warmup=1)
        bms, by = bound(VML_FLOPS[op] * float(VML_N), 8.0 * VML_N)
        emit(15, op=op, n=VML_N, launches=launches[op], bitwise=True,
             ulp_vs=ulps, ms=ms, libm_ms=libm_ms, torch_ms=lib_ms,
             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
             fraction_of_bound=bms / ms)
        entries.append({"name": f"cuda_target/vml_{op}", "source": VML_SOURCE,
                        "launches": launches[op], "max_abs_err": 0.0,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "library_ms": lib_ms})
        del got, plain, libm, bufs
    return entries


# ---------------------------------------------------------------------------
# phase 16: the scoreboard
# ---------------------------------------------------------------------------

def scoreboards(ctx):
    """The card-set and ci-set Scoreboards over one fresh tuning table
    (``build/repro_torch/phase16_tuning.json``); the ci board reuses the
    card board's vector and cuda peaks."""
    from repro_torch.core import TuningTable
    from repro_torch.core.nvcc import BUILD_DIR
    from repro_torch.suite import Scoreboard
    path = BUILD_DIR / "phase16_tuning.json"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    table = TuningTable(str(path))
    card = Scoreboard(ctx=ctx, table=table, shape_set="card", warmup=0,
                      repeats=SB_REPEATS)
    ci = Scoreboard(ctx=ctx, table=table, shape_set="ci",
                    targets=("loop", "vector", "cuda"), warmup=0, repeats=1,
                    max_configs=2, include_coexec=False, include_auto=False)
    return card, ci


def scoreboard_phase(card, ci):
    """Phase 16: both boards, their gates, reports and summaries."""
    from repro_torch.core.nvcc import BUILD_DIR
    from repro_torch.launch.scoreboard import summary_lines
    from repro_torch.suite import check_gates, render_markdown
    t0 = time.perf_counter()
    for name, board in (("card", card), ("ci", ci)):
        t1 = time.perf_counter()
        if board is ci:     # peaks calibrated on this card already
            ci.peaks.update({t: card.peaks[t] for t in ("vector", "cuda")})
        report = board.run()
        report["gates"] = check_gates(report, min_fraction=0.0)
        stem = BUILD_DIR / f"phase16_scoreboard_{name}"
        stem.with_suffix(".json").write_text(
            json.dumps(report, indent=1, default=float))
        md = render_markdown(report)
        stem.with_suffix(".md").write_text(md)
        print(md, flush=True)
        print("\n".join(summary_lines(report)), flush=True)
        gates = report["gates"]
        emit(16, shape_set=name, seconds=time.perf_counter() - t1,
             targets=report["targets"], absent=report.get("absent"),
             peaks=report["peaks"], datasheet=report["datasheet"],
             calibration=report["calibration"],
             above_roofline=report["above_roofline"], gates=gates,
             cells={f"{k}/{t}": {"config": c["config"],
                                 "time_us": c["time_us"],
                                 "wall_us": c["wall_us"],
                                 "fraction": c["roofline"]["fraction"],
                                 "fraction_datasheet":
                                     c["fraction_datasheet"],
                                 **({"chosen": c["chosen_target"]}
                                    if "chosen_target" in c else {})}
                    for k, ent in report["kernels"].items()
                    for t, c in ent["cells"].items()})
        assert gates["bitwise"], (name, gates["bitwise_failures"])
        assert gates["winner_beats_worst"], (name, gates["winner_failures"])
    seconds = time.perf_counter() - t0
    emit(16, part="done", seconds=seconds, limit_s=SB_LIMIT_S)
    assert seconds < SB_LIMIT_S, ("scoreboard phase", seconds)


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
    from repro_torch.core.examples import (build_quantize, build_residual_add,
                                           build_rmsnorm_ew)
    from repro_torch.core.interp import run_ndrange
    from repro_torch.core.nvcc import build_parallel
    from repro_torch.kernels import KERNELS
    from repro_torch.runtime import Context
    from repro_torch.suite import SUITE
    from repro_torch.suite.scoreboard import expected_outputs

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
    host_prog = ctx.create_program(build_scale, build_offset).build()
    chain_prog = ctx.create_program(build_rmsnorm_ew, build_residual_add,
                                    build_quantize).build()
    lops_prog = ctx.create_program(build_coexec_scale).build()
    auto_runs = []
    for name, sk in SUITE.items():
        shape = sk.shapes["full"]
        params = next(iter(sk.space(shape)))
        auto_runs.append((name, sk, shape, params,
                          ctx.create_program(sk.build(shape, params))))
    warm_queue, warm_bufs, fused_spec = warm_fused_chain(ctx, cuda_dev,
                                                         chain_prog)
    vml_progs = vml_programs(ctx)
    sb_card, sb_ci = scoreboards(ctx)
    binaries = [dot_prog.create_kernel().bind(cuda_dev, (QS_LSZ,))]
    binaries += [r[3].create_kernel().bind(cuda_dev, r[6]) for r in case_runs]
    for runs in (full_runs, real_runs, auto_runs):
        for name, sk, shape, params, prog in runs:
            binaries.append(prog.create_kernel().bind(
                cuda_dev, sk.launch_dims(shape, params)[1]))
    binaries += [host_prog.create_kernel(n).bind(cuda_dev, (HOST_LSZ,))
                 for n in ("scale", "offset")]
    binaries += [chain_prog.create_kernel(n).bind(cuda_dev, (CHAIN_LSZ,))
                 for n in CHAIN]
    binaries.append(fused_spec.program.binary_for(
        fused_spec.kernel_name, (CHAIN_LSZ,), device=cuda_dev))
    binaries.append(lops_prog.create_kernel().bind(cuda_dev, (LOPS_LSZ,)))
    binaries += [p.create_kernel().bind(cuda_dev, (VML_LSZ,))
                 for pair in vml_progs.values() for p in pair]
    binaries += sb_card.cuda_binaries() + sb_ci.cuda_binaries()
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
    warm_queue.finish()
    assert warm_queue.dag_stats()["fused_chains"] == 1
    for b in warm_bufs.values():
        b.release()

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
        expected = expected_outputs(sk, inputs, shape, params)
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
    torch.cuda.empty_cache()

    # -- 13. the host runtime (main path) --------------------------------------------
    t13 = time.perf_counter()
    entries.append(host_runtime_phase(torch, np, time_ms, flush, ctx,
                                      cuda_dev, vec_dev, host_prog,
                                      chain_prog, fused_spec, reset_counts))
    emit(13, part="done", seconds=time.perf_counter() - t13)
    torch.cuda.empty_cache()

    # -- 14. co-execution and the autotuner (main path) ---------------------------
    t14 = time.perf_counter()
    coexec_phase(torch, np, time_ms, ctx, cuda_dev, vec_dev, host_prog,
                 real_runs, auto_runs)
    emit(14, part="done", seconds=time.perf_counter() - t14)

    # -- 15. vml on the card (main path) ---------------------------------------
    t15 = time.perf_counter()
    entries += vml_phase(torch, np, time_ms, ctx, cuda_dev, vec_dev,
                         vml_progs, reset_counts)
    emit(15, part="done", seconds=time.perf_counter() - t15)
    torch.cuda.empty_cache()

    # -- 16. the performance-portability scoreboard -------------------------------
    scoreboard_phase(sb_card, sb_ci)

    # -- 17. kernels line, card, result --------------------------------------------
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
