"""The port's performance-portability scoreboard
(``repro_torch.suite.scoreboard``) on the CPU, held against the
reference's (``repro.suite.scoreboard``).

The port of ``tests/test_scoreboard.py`` on ``Platform(torch_device=
"cpu")`` at the ``ci`` shapes with two configurations a space: a complete
kernel x target matrix with the reference's kernels, configurations and
space sizes, every cell bitwise-equal to its oracle, both gates passing
(and failing on a planted non-bitwise cell and on a ``min_fraction`` above
every fraction), sweep winners persisted and reused — from a table file
the reference wrote too — the reference's markdown for one report dict,
``kernel_report``'s numbers and refusals equal to the reference's, and
ROADMAP C.13: co-devices of one CPU priced once, so the port's coexec2
peaks are half the reference's and its fraction twice.  The card-sized
oracles the scoreboard uses (GEMM through a float64 product, the
histogram in one ``bincount``, SpMV's CSR structure in array
operations) equal the suite's own bitwise.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.core.autotune import TuningTable
from repro_torch.core.errors import InvalidArgError
from repro_torch.launch import scoreboard as cli
from repro_torch.launch.roofline import kernel_report
from repro_torch.runtime import Context, DeviceNotFoundError, Platform
from repro_torch.suite import (SUITE, Scoreboard, calibrate, check_gates,
                               render_markdown)
from repro_torch.suite.scoreboard import (CARD_SHAPES, case_inputs,
                                          expected_outputs, shape_for)

# a fast 2-kernel subset exercises every cell type (incl. a 2-D NDRange)
FAST = ["stencil1d", "stencil2d"]
TARGETS = ("loop", "vector")


@pytest.fixture(scope="module")
def ctx():
    return Context(platform=Platform(torch_device="cpu"))


def _opts(**kw):
    opts = dict(shape_set="ci", warmup=0, repeats=1, max_configs=2,
                include_coexec=True, include_auto=False,
                calibration_n=1 << 10)
    opts.update(kw)
    return opts


def _fast_board(ctx, table, **kw):
    return Scoreboard(ctx=ctx, table=table, **_opts(**kw))


@pytest.fixture(scope="module")
def report(ctx, tmp_path_factory):
    table = TuningTable(tmp_path_factory.mktemp("scoreboard") / "tuning.json")
    return _fast_board(ctx, table).run(kernels=FAST)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference scoreboard over the same kernels and targets, and the
    tuning table file it wrote."""
    pytest.importorskip("jax")
    from repro.core.autotune import TuningTable as JTable
    from repro.runtime import Context as JContext
    from repro.suite import Scoreboard as JScoreboard
    path = tmp_path_factory.mktemp("reference") / "tuning.json"
    board = JScoreboard(ctx=JContext(), table=JTable(path), targets=TARGETS,
                        **_opts())
    return board.run(kernels=FAST), path


def test_matrix_complete(report):
    assert report["schema"] == "bench_scoreboard/v1"
    assert report["targets"] == list(TARGETS)
    assert set(report["kernels"]) == set(FAST)
    for name, entry in report["kernels"].items():
        cells = entry["cells"]
        assert set(cells) == {"loop", "vector", "coexec2"}
        for tgt, cell in cells.items():
            assert cell["bitwise"], (name, tgt)
            assert cell["time_us"] > 0
            assert cell["roofline"]["fraction"] > 0
            assert "wall_us" not in cell      # device metrics: card only
    assert "datasheet" not in report and "absent" not in report


def test_matrix_matches_the_references(report, reference):
    ref, _ = reference
    assert set(ref["kernels"]) == set(report["kernels"])
    for name, ent in report["kernels"].items():
        rent = ref["kernels"][name]
        for key in ("shape", "space_size", "flops", "bytes"):
            assert ent[key] == rent[key], (name, key)
        assert set(ent["cells"]) == set(rent["cells"])
        for tgt in TARGETS:
            assert set(ent["cells"][tgt]["timings_us"]) == \
                set(rent["cells"][tgt]["timings_us"]), (name, tgt)
            assert set(ent["cells"][tgt]) >= set(rent["cells"][tgt])
        assert set(ent["cells"]["coexec2"]) == set(rent["cells"]["coexec2"])
    assert set(report["gates"]) == set(ref["gates"])


def test_winner_beats_worst(report):
    for name, entry in report["kernels"].items():
        for tgt in TARGETS:
            cell = entry["cells"][tgt]
            timings = cell["timings_us"]
            assert len(timings) >= 2
            assert cell["best_us"] == min(timings.values())
            assert cell["best_us"] <= cell["worst_us"]
            assert cell["speedup_vs_worst"] >= 1.0
            assert cell["time_us"] == cell["best_us"]


def test_gates_pass(report):
    gates = check_gates(report, min_fraction=0.0)
    assert gates["ok"], gates
    assert gates["bitwise"] and not gates["bitwise_failures"]
    assert gates["winner_beats_worst"] and not gates["winner_failures"]


def test_gate_detects_bitwise_failure(report):
    broken = json.loads(json.dumps(report))  # deep copy
    broken["kernels"][FAST[0]]["cells"]["vector"]["bitwise"] = False
    gates = check_gates(broken, min_fraction=0.0)
    assert not gates["ok"] and not gates["bitwise"]
    assert gates["bitwise_failures"] == [f"{FAST[0]}/vector"]


def test_gate_min_fraction(report):
    above = 1.01 * max(ent["cells"]["vector"]["roofline"]["fraction"]
                       for ent in report["kernels"].values())
    gates = check_gates(report, min_fraction=above, fraction_target="vector")
    assert not gates["fraction_ok"] and not gates["ok"]
    failed = {f.split(":")[0] for f in gates["fraction_failures"]}
    assert failed == set(FAST)


def test_gates_are_the_references(report):
    pytest.importorskip("jax")
    from repro.suite.scoreboard import check_gates as jcheck
    broken = json.loads(json.dumps(report))
    broken["kernels"][FAST[1]]["cells"]["loop"]["best_us"] = 1e9
    for rep in (report, broken):
        for frac in (0.0, 1e-9, 1e9):
            assert check_gates(rep, min_fraction=frac) == \
                jcheck(rep, min_fraction=frac)


def test_sweep_persists_and_is_reused(ctx, tmp_path):
    """Second run against the same table re-measures only the recorded
    winner (sweep_cached=True) and lands on identical parameters."""
    path = tmp_path / "tuning.json"
    first = _fast_board(ctx, TuningTable(path),
                        include_coexec=False).run(kernels=["stencil1d"])

    raw = json.loads(path.read_text())
    assert raw["sweeps"], "winning sweep not persisted to the TuningTable"
    for rec in raw["sweeps"].values():
        assert set(rec) == {"params", "timings_us"}

    second = _fast_board(ctx, TuningTable(path),
                         include_coexec=False).run(kernels=["stencil1d"])
    for tgt in TARGETS:
        c1 = first["kernels"]["stencil1d"]["cells"][tgt]
        c2 = second["kernels"]["stencil1d"]["cells"][tgt]
        assert not c1["sweep_cached"]
        assert c2["sweep_cached"], tgt
        assert c2["params"] == c1["params"]


def test_a_table_the_reference_wrote_is_reused(ctx, reference, tmp_path):
    ref, path = reference
    copy = tmp_path / "tuning.json"
    copy.write_text(path.read_text())
    got = _fast_board(ctx, TuningTable(copy),
                      include_coexec=False).run(kernels=FAST)
    for name in FAST:
        for tgt in TARGETS:
            cell = got["kernels"][name]["cells"][tgt]
            assert cell["sweep_cached"], (name, tgt)
            assert cell["params"] == ref["kernels"][name]["cells"][tgt][
                "params"]
            assert cell["timings_us"] == ref["kernels"][name]["cells"][tgt][
                "timings_us"]


def test_render_markdown_is_the_references(report, reference):
    pytest.importorskip("jax")
    from repro.suite import render_markdown as jrender
    ref, _ = reference
    for rep in (report, ref):
        assert render_markdown(rep) == jrender(rep)
    md = render_markdown(report)
    for name in FAST:
        assert f"\n| {name} " in md
    for col in ("loop", "vector", "coexec2"):
        assert col in md
    assert md.count("\n|") >= len(FAST) + 1


def test_calibrate_positive(ctx):
    peaks = calibrate(ctx, "loop", n=1 << 8, warmup=0, repeats=1)
    assert peaks["peak_flops"] > 0
    assert peaks["peak_bw"] > 0


KR_CASES = [
    dict(flops=2e9, bytes_moved=1e8, time_s=1.0, peak_flops=4e9,
         peak_bw=1e9),
    dict(flops=1e6, bytes_moved=8e8, time_s=0.25, peak_flops=4e9,
         peak_bw=1e9),
    dict(flops=3.0, bytes_moved=5.0, time_s=1e-13, peak_flops=1.0,
         peak_bw=1.0),
]


def test_kernel_report_math():
    r = kernel_report(kernel="gemm", target="vector", flops=2e9,
                      bytes_moved=1e8, time_s=1.0, peak_flops=4e9,
                      peak_bw=1e9)
    assert r.t_compute == pytest.approx(0.5)
    assert r.t_memory == pytest.approx(0.1)
    assert r.t_bound == pytest.approx(0.5)
    assert r.dominant == "compute"
    assert r.fraction == pytest.approx(0.5)
    assert r.achieved_gflops == pytest.approx(2.0)
    d = r.to_dict()
    assert d["kernel"] == "gemm" and d["fraction"] == pytest.approx(0.5)


@pytest.mark.parametrize("case", range(len(KR_CASES)))
def test_kernel_report_is_the_references(case):
    pytest.importorskip("jax")
    from repro.launch.roofline import kernel_report as jreport
    kw = dict(kernel="k", target="cuda", **KR_CASES[case])
    assert kernel_report(**kw).to_dict() == jreport(**kw).to_dict()


BAD = [dict(flops=0.0), dict(time_s=0.0), dict(peak_bw=-1.0),
       dict(peak_flops=float("nan")), dict(bytes_moved=float("inf")),
       dict(flops="1")]


@pytest.mark.parametrize("bad", BAD)
def test_kernel_report_validates(bad):
    kw = dict(kernel="k", target="loop", flops=1.0, bytes_moved=1.0,
              time_s=1.0, peak_flops=1.0, peak_bw=1.0)
    kw.update(bad)
    with pytest.raises(ValueError):
        kernel_report(**kw)
    pytest.importorskip("jax")
    from repro.launch.roofline import kernel_report as jreport
    with pytest.raises(ValueError):
        jreport(**kw)


def test_a_fraction_above_one_is_kept(report):
    r = kernel_report(kernel="k", target="t", flops=4.0, bytes_moved=1.0,
                      time_s=1.0, peak_flops=1.0, peak_bw=1.0)
    assert r.fraction == 4.0        # flagged by the scoreboard, not clamped
    assert report["above_roofline"] == [
        f"{n}/{t}: {c['roofline']['fraction']:.4f}"
        for n, e in report["kernels"].items() for t, c in e["cells"].items()
        if c["roofline"]["fraction"] > 1]


def test_tuning_table_sweep_roundtrip(tmp_path):
    path = tmp_path / "t.json"
    t = TuningTable(path)
    key = TuningTable.make_sweep_key("gemm", "vector", "m=4,n=4")
    assert t.get_sweep(key) is None
    t.record_sweep(key, {"ts": 8}, {"ts=4": 10.0, "ts=8": 5.0})
    rec = TuningTable(path).get_sweep(key)
    assert rec == {"params": {"ts": 8},
                   "timings_us": {"ts=4": 10.0, "ts=8": 5.0}}
    # a poisoned measurement is dropped, never recorded as a warm start
    t.record_sweep(key, {"ts": 4}, {"ts=4": float("nan")})
    assert t.get_sweep(key)["params"] == {"ts": 8}


def test_suite_unknown_kernel_rejected(ctx, tmp_path):
    board = _fast_board(ctx, TuningTable(tmp_path / "t.json"))
    with pytest.raises(KeyError):
        board.run(kernels=["nonexistent"])
    assert "nonexistent" not in SUITE


def test_numpy_unchanged_inputs(ctx, tmp_path):
    """Scoreboard runs must not mutate the suite's input arrays across
    cells — each launch gets fresh copies."""
    sk = SUITE["stencil1d"]
    shape = sk.shapes["ci"]
    params = sk.space(shape)[0]
    before = {k: v.copy() for k, v in sk.make_inputs(shape, params).items()}
    _fast_board(ctx, TuningTable(tmp_path / "t.json"),
                include_coexec=False).run(kernels=["stencil1d"])
    after = sk.make_inputs(shape, params)
    for k, v in before.items():
        assert np.array_equal(v, after[k])


def test_c13_coexec2_is_priced_once_per_device(ctx):
    """Two vector co-devices of one CPU share its cores and memory: the
    port prices coexec2 at the vector peaks once, the reference at twice
    them, so for the same time the port's fraction is twice the
    reference's."""
    pytest.importorskip("jax")
    from repro.runtime import Context as JContext
    from repro.suite import SUITE as JSUITE, Scoreboard as JScoreboard
    peaks = {"vector": {"peak_flops": 4e9, "peak_bw": 2e9}}
    sk = SUITE["stencil1d"]
    shape = sk.shapes["ci"]
    base = {"params": dict(sk.space(shape)[0]), "time_us": 2000.0}
    port = _fast_board(ctx, TuningTable())
    port.peaks = {t: dict(p) for t, p in peaks.items()}
    port._measure = lambda *a, **k: (1e-3, 1e-3, True, None)
    ref = JScoreboard(ctx=JContext(), targets=("vector",), **_opts())
    ref.peaks = {t: dict(p) for t, p in peaks.items()}
    ref._measure = lambda *a, **k: (1e-3, True, None)
    got = port._coexec_cell(sk, shape, base)
    want = ref._coexec_cell(JSUITE["stencil1d"], shape, base)
    for k in ("peak_flops", "peak_bw"):
        assert got["roofline"][k] == peaks["vector"][k]
        assert want["roofline"][k] == 2 * got["roofline"][k]
    assert got["roofline"]["fraction"] == pytest.approx(
        2 * want["roofline"]["fraction"], rel=1e-12)
    assert got["speedup_vs_vector"] == want["speedup_vs_vector"]


# ---------------------------------------------------------------------------
# the card shape set and its oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SUITE))
def test_card_shapes_are_phase_5s(name):
    sk = SUITE[name]
    assert shape_for(sk, "card") == CARD_SHAPES[name]
    assert shape_for(sk, "ci") == sk.shapes["ci"]
    assert shape_for(sk, "nonexistent") == sk.shapes["full"]
    assert sk.space(CARD_SHAPES[name]), name


def test_card_shape_set_needs_a_card(ctx):
    board = Scoreboard(ctx=ctx, shape_set="card")
    with pytest.raises(InvalidArgError):
        board.run(kernels=["stencil1d"])


@pytest.mark.parametrize("name", ["gemm", "hist"])
@pytest.mark.parametrize("which", ["ci", "full"])
def test_fast_oracles_equal_the_suites(name, which):
    sk = SUITE[name]
    shape = sk.shapes[which]
    for params in sk.space(shape):
        inputs = sk.make_inputs(shape, params)
        want = sk.oracle(inputs, shape, params)
        got = expected_outputs(sk, inputs, shape, params)
        for o in sk.outputs:
            assert got[o].dtype == want[o].dtype
            assert got[o].tobytes() == want[o].tobytes(), (name, params)


@pytest.mark.parametrize("shape", [
    {"m": 70, "n": 64, "max_nnz": 4}, {"m": 300, "n": 256, "max_nnz": 8},
    {"m": 5003, "n": 977, "max_nnz": 8}, {"m": 1, "n": 1, "max_nnz": 3}])
def test_fast_inputs_equal_the_suites(shape):
    sk = SUITE["spmv"]
    params = sk.space(shape)[-1]
    want = sk.make_inputs(shape, params)
    got = case_inputs(sk, shape, params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    stencil = SUITE["stencil1d"]
    for k, v in case_inputs(stencil, {"n": 150},
                            stencil.space({"n": 150})[0]).items():
        assert v.tobytes() == stencil.make_inputs(
            {"n": 150}, stencil.space({"n": 150})[0])[k].tobytes()


def test_gemm_oracle_falls_back_where_a_product_is_inexact():
    sk = SUITE["gemm"]
    shape = {"m": 9, "n": 7, "k": 33}
    params = sk.space(shape)[0]
    rng = np.random.default_rng(0)
    inputs = {"A": rng.standard_normal(9 * 33).astype(np.float32),
              "B": rng.standard_normal(33 * 7).astype(np.float32),
              "C": np.zeros(63, np.float32)}
    want = sk.oracle(inputs, shape, params)["C"]
    assert expected_outputs(sk, inputs, shape, params)["C"].tobytes() == \
        want.tobytes()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_command_line_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(DeviceNotFoundError):
        cli.main(["--ci", "--kernels", "stencil1d"])


def test_command_line_writes_the_matrix(report, monkeypatch, tmp_path,
                                        capsys):
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return json.loads(json.dumps(report))
    monkeypatch.setattr(cli, "run", fake_run)
    out, md = tmp_path / "sb" / "m.json", tmp_path / "sb" / "m.md"
    got = cli.main(["--ci", "--device", "cpu", "--kernels", *FAST,
                    "--out", str(out), "--md", str(md)])
    assert seen["device"] == "cpu" and seen["ci"] and \
        seen["kernels"] == FAST and seen["shape_set"] is None
    assert json.loads(out.read_text())["kernels"].keys() == \
        report["kernels"].keys()
    assert md.read_text() == render_markdown(got)
    text = capsys.readouterr().out
    assert "scoreboard gates" in text and "peaks vector" in text
