"""The repo's entry points on the PyTorch/H100 port, run on the CPU.

Each new example (``examples/torch_quickstart.py``,
``torch_opencl_runtime.py``, ``torch_serve_lm.py``, ``torch_train_lm.py``)
and ``tools/dump_pipeline_torch.py`` runs with ``--device cpu`` in a
subprocess, as a user would run it.  The quickstart's and the
walk-through's printed results equal the reference examples' (the
walk-through's device names and event times differ by design: the
port's CPU platform has no ``pallas`` device); the dump tool's IR
sections equal ``tools/dump_pipeline.py``'s line for line, except the
per-pass timings.  Without ``--device`` and without a card each one
raises ``DeviceNotFoundError``.
"""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["examples/torch_quickstart.py", "examples/torch_opencl_runtime.py",
            "examples/torch_serve_lm.py", "examples/torch_train_lm.py",
            "tools/dump_pipeline_torch.py"]


def run(rel, *args, reference=False, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if reference:
        env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.join(ROOT, rel), *args],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=timeout)
    return r


def ok(rel, *args, **kw):
    r = run(rel, *args, **kw)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def needs_reference():
    pytest.importorskip("jax")


def test_quickstart_prints_the_reference_results():
    needs_reference()
    got = ok("examples/torch_quickstart.py", "--device", "cpu")
    want = ok("examples/quickstart.py", reference=True)
    assert got == want
    assert "target=loop" in got and "target=vector" in got


def _walkthrough_results(text):
    """The walk-through's results: the pipeline's line, the enqueued
    commands in order, and the co-execution's groups and migrations."""
    pipeline = next(ln for ln in text.splitlines()
                    if ln.startswith("pipeline OK"))
    events = re.findall(r"^  (\S+)\s+queued=", text, re.M)
    m = re.search(r"co-execution OK: groups per device (\{.*\}), "
                  r"(\d+) buffer migrations", text)
    groups = ast.literal_eval(m.group(1))
    return pipeline, events, sorted(groups.values()), int(m.group(2))


def test_opencl_runtime_prints_the_reference_results():
    needs_reference()
    got = ok("examples/torch_opencl_runtime.py", "--device", "cpu")
    want = ok("examples/opencl_runtime.py", reference=True)
    assert _walkthrough_results(got) == _walkthrough_results(want)
    assert "buffer on cpu, 2 launches on repro-vector-cpu" in got


def test_serve_lm_runs_on_cpu():
    out = ok("examples/torch_serve_lm.py", "--device", "cpu")
    assert out.startswith("served 6 requests")
    assert len(re.findall(r"^  req\d+: prompt", out, re.M)) == 6
    assert "FAILED" not in out


def test_train_lm_runs_on_cpu_and_resumes(tmp_path):
    """Further arguments reach ``repro_torch.launch.train`` as they are:
    a checkpoint every 5 steps, and a second run over the same directory
    resumes from the last one."""
    args = ["--device", "cpu", "--steps", "12", "--batch", "4", "--seq",
            "32", "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "5"]
    out = ok("examples/torch_train_lm.py", *args)
    assert "training smollm-smoke from step 0 on cpu" in out
    assert "12 steps in" in out
    losses = [float(x) for x in re.findall(r"'loss': ([\d.]+)", out)]
    assert losses and all(0 < x < 20 for x in losses)
    again = ok("examples/torch_train_lm.py", *args)
    assert "training smollm-smoke from step 10 on cpu" in again


TIMING = re.compile(r"  [a-z_]+ +\d+\.\d+")


def _ir_lines(text):
    """The dump's lines before the cuda section, per-pass timings left
    out (they are the host's clock)."""
    head = text.split("the cuda work-group target")[0]
    return [ln for ln in head.splitlines() if not TIMING.fullmatch(ln)]


def test_dump_pipeline_ir_equals_the_reference_tool():
    needs_reference()
    got = ok("tools/dump_pipeline_torch.py", "--device", "cpu")
    want = ok("tools/dump_pipeline.py", reference=True)
    assert "per-pass timings" in want
    port, ref = _ir_lines(got), _ir_lines(want)
    # the port's dump ends its shared part with the banner of its cuda
    # section; everything before it is the reference tool's output
    assert port[:len(ref)] == ref
    assert port[len(ref):] == ["", "=" * 72]


def test_dump_pipeline_shows_the_cuda_target():
    out = ok("tools/dump_pipeline_torch.py", "--device", "cpu")
    cuda = out.split("the cuda work-group target")[1]
    assert cuda.count("### cuda mapping") == 3
    assert cuda.count("### emitted CUDA") == 3
    assert cuda.count('#include "wg_runtime.cuh"') == 3
    # reduce2 keeps its two explicit barriers and drops the implicit ones
    assert "barriers: 2 of 7 kept as __syncthreads()" in cuda
    assert "region transitions: direct" in cuda
    assert re.search(r"  \S+: explicit, kept", cuda)
    assert re.search(r"  \S+: bloop-header, dropped", cuda)
    assert "extern \"C\" __global__" in cuda


@pytest.mark.parametrize("rel", EXAMPLES)
def test_without_a_card_each_entry_point_raises_device_not_found(rel):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is found")
    r = run(rel)
    assert r.returncode != 0
    assert "DeviceNotFoundError" in r.stderr
