"""The port's serving path (``repro_torch.serving``, ``runtime``,
``launch.serve``) held against the reference on the CPU.

* The copied modules differ from their originals in their imports only,
  and the engine's scheduler, paging, preemption and fault logic is the
  reference's, method by method.
* Scheduler scenarios of ``tests/test_serving_sched.py`` run through both
  packages' engines on the deterministic ``StubExecutor``: identical
  streams, request states, errors, ``scheduler_stats`` and ``kv_stats``
  after every step.
* ``TorchExecutor`` at the smoke config: the streams equal the port's own
  teacher-forced serial oracle, are independent of co-tenants, and match
  the reference's ``JaxExecutor`` token for token — except from a step
  where the reference's top-two logit gap is below the logits tolerance
  of ``tests/test_torch_models.py`` (``3e-2`` in bfloat16, ``1e-5`` in
  float32), where the two frameworks may rightly pick different tokens;
  that request's comparison stops there.
"""

import inspect
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.runtime as jrt  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import errors as jerrors  # noqa: E402
from repro.distributed.sharding import BASELINE_RULES  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import executor as jexecutor  # noqa: E402

import repro_torch.runtime as trt  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import errors as terrors  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import forward, init_caches  # noqa: E402
from repro_torch.models import init_params, params_from_jax  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import executor as texecutor  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-135m"


def _code(text):
    """Source lines without the import statements."""
    return [ln for ln in text.splitlines()
            if not ln.lstrip().startswith(("from ", "import "))]


@pytest.mark.parametrize("rel", ["runtime/events.py", "runtime/bufalloc.py"])
def test_copies_differ_only_in_imports(rel):
    with open(os.path.join(ROOT, "src", "repro", rel)) as f:
        orig = _code(f.read())
    with open(os.path.join(ROOT, "src", "repro_torch", rel)) as f:
        copy = _code(f.read())
    assert copy == orig


@pytest.mark.parametrize("name", ["BatchExecutor", "StubExecutor"])
def test_executor_copies(name):
    assert inspect.getsource(getattr(texecutor, name)) == \
        inspect.getsource(getattr(jexecutor, name))


def test_buffer_pool_is_the_reference_pool():
    from repro.runtime.memory import BufferPool as J
    from repro_torch.runtime.memory import BufferPool as T
    assert inspect.getsource(T) == inspect.getsource(J)


def test_engine_logic_is_the_reference_logic():
    """Everything but the constructor (imports, the dropped ``rules``
    argument, the default executor) is the reference's source."""
    for name in ("RequestState", "Request", "_Slot"):
        assert inspect.getsource(getattr(tengine, name)) == \
            inspect.getsource(getattr(jengine, name))
    tcls, jcls = tengine.ServingEngine, jengine.ServingEngine
    names = {n for n, v in vars(jcls).items()
             if callable(v) or isinstance(v, property)}
    assert names == {n for n, v in vars(tcls).items()
                     if callable(v) or isinstance(v, property)}
    for n in sorted(names - {"__init__"}):
        j, t = vars(jcls)[n], vars(tcls)[n]
        if isinstance(j, property):
            j, t = j.fget, t.fget
        assert _code(inspect.getsource(t)) == \
            _code(inspect.getsource(j)), n


# ---------------------------------------------------------------------------
# scheduler scenarios through both engines (StubExecutor)
# ---------------------------------------------------------------------------

PKGS = {
    "ref": dict(serving=jserving, errors=jerrors,
                context=lambda: jrt.Context(),
                engine=lambda *a, **kw: jserving.ServingEngine(
                    None, None, None, *a, **kw)),
    "port": dict(serving=tserving, errors=terrors,
                 context=lambda: trt.Context(
                     platform=trt.Platform(torch_device="cpu")),
                 engine=lambda *a, **kw: tserving.ServingEngine(
                     None, None, *a, **kw)),
}


class _Run:
    """One scenario on one package: builds engines and requests, records
    what every step did."""

    def __init__(self, pkg):
        self.p = PKGS[pkg]
        self.trace = []
        self.reqs = []

    def engine(self, slots=2, max_seq=64, bytes_per_token=64, **kw):
        ex = self.p["serving"].StubExecutor(batch_slots=slots,
                                            max_seq=max_seq,
                                            bytes_per_token=bytes_per_token)
        eng = self.p["engine"](batch_slots=slots, max_seq=max_seq,
                               executor=ex, context=self.p["context"](), **kw)
        return eng, ex

    def req(self, rng, plen=None, max_new=4, **kw):
        plen = plen or int(rng.integers(3, 9))
        r = self.p["serving"].Request(
            prompt=rng.integers(0, 500, plen).astype(np.int32),
            max_new_tokens=max_new, **kw)
        self.reqs.append(r)
        return r

    def step(self, eng):
        out = eng.step()
        self.record(eng, out)
        return out

    def drain(self, eng):
        while eng.scheduler_stats["waiting"] or \
                eng.scheduler_stats["running"]:
            self.step(eng)

    def record(self, eng, out):
        self.trace.append((sorted(r.id for r in out),
                           dict(eng.scheduler_stats), dict(eng.kv_stats)))

    def result(self):
        return self.trace, [
            (r.id, list(r.out_tokens or []), r.state, r.done,
             type(r.error).__name__ if r.error else None,
             str(r.error) if r.error else None, r.preemptions,
             r.submit_step, r.finish_step) for r in self.reqs]


def sc_eviction_refill(run):
    eng, _ = run.engine(slots=1)
    a = run.p["serving"].Request(prompt=np.arange(3, dtype=np.int32),
                                 max_new_tokens=2)
    b = run.p["serving"].Request(prompt=np.arange(4, dtype=np.int32),
                                 max_new_tokens=3)
    run.reqs += [a, b]
    eng.submit(a)
    eng.submit(b)
    run.step(eng)
    run.step(eng)
    assert b.state == "running" and len(b.out_tokens) == 1
    run.drain(eng)


def sc_oom_preemption(run):
    eng, _ = run.engine(slots=2, page_tokens=4, kv_budget_bytes=12 * 4 * 64)
    rng = np.random.default_rng(1)
    for r in (run.req(rng, plen=8, max_new=30),
              run.req(rng, plen=9, max_new=30)):
        eng.submit(r)
    run.drain(eng)
    assert eng.scheduler_stats["preemptions"] >= 1
    assert isinstance(eng.last_oom, run.p["serving"].engine.OutOfMemory)


def sc_priority_victim(run):
    eng, _ = run.engine(slots=2, page_tokens=4, kv_budget_bytes=10 * 4 * 64)
    rng = np.random.default_rng(2)
    hi = run.req(rng, plen=6, max_new=28, priority=1)
    lo = run.req(rng, plen=6, max_new=28, priority=0)
    eng.submit(hi)
    eng.submit(lo)
    run.drain(eng)
    assert lo.preemptions >= 1 and hi.preemptions == 0


def sc_sole_resident_oom(run):
    eng, _ = run.engine(slots=1, page_tokens=4, kv_budget_bytes=3 * 4 * 64)
    r = run.p["serving"].Request(prompt=np.arange(8, dtype=np.int32),
                                 max_new_tokens=30)
    run.reqs.append(r)
    eng.submit(r)
    run.drain(eng)
    assert r.state == "failed"


def sc_decode_fault(run):
    eng, _ = run.engine(slots=2)
    rng = np.random.default_rng(5)
    good, bad, late = run.req(rng, max_new=6), run.req(rng, max_new=6), \
        run.req(rng, max_new=2)
    for r in (good, bad, late):
        eng.submit(r)
    eng.inject_fault(bad, stage="decode")
    run.drain(eng)
    assert bad.state == "failed" and good.done and late.done


def sc_prefill_fault(run):
    eng, _ = run.engine(slots=2)
    rng = np.random.default_rng(6)
    good, bad = run.req(rng, max_new=4), run.req(rng, max_new=4)
    eng.submit(good)
    eng.submit(bad)
    eng.inject_fault(bad, stage="prefill",
                     error=run.p["errors"].DeviceLostError("boom"))
    run.drain(eng)
    assert str(bad.error) == "boom" and good.done


def sc_device_loss(run):
    eng, _ = run.engine(slots=2)
    rng = np.random.default_rng(7)
    a, b, queued = run.req(rng, max_new=8), run.req(rng, max_new=8), \
        run.req(rng, max_new=4)
    for r in (a, b, queued):
        eng.submit(r)
    run.step(eng)
    eng.inject_fault(stage="device")
    run.step(eng)
    assert a.error is b.error is eng.device_lost
    with pytest.raises(run.p["errors"].DeviceLostError):
        eng.drain()
    assert eng.release_waiting() == [queued] and queued.error is None
    run.record(eng, [])


def sc_fixed_scheduler(run):
    eng, _ = run.engine(slots=2, scheduler="fixed")
    rng = np.random.default_rng(9)
    reqs = [run.req(rng, max_new=m) for m in (2, 5, 3)]
    for r in reqs:
        eng.submit(r)
    run.step(eng)
    run.step(eng)
    run.step(eng)
    assert reqs[0].done and reqs[2].state == "waiting"
    run.drain(eng)


def sc_long_request(run):
    for scheduler in ("continuous", "fixed"):
        eng, _ = run.engine(slots=2, scheduler=scheduler)
        rng = np.random.default_rng(0)
        for r in [run.req(rng, plen=5, max_new=24)] + \
                [run.req(rng, max_new=2) for _ in range(5)]:
            eng.submit(r)
        run.drain(eng)


def sc_pages_per_eviction(run):
    eng, _ = run.engine(slots=2, page_tokens=4)
    rng = np.random.default_rng(3)
    for r in [run.req(rng, plen=6, max_new=3) for _ in range(4)]:
        eng.submit(r)
    run.drain(eng)
    assert eng.kv_stats["pages_live"] == 0


def sc_front_submit_and_eos(run):
    eng, ex = run.engine(slots=1)
    rng = np.random.default_rng(10)
    first, second, migrated = run.req(rng), run.req(rng), \
        run.req(rng, max_new=2)
    eos = run.req(rng, plen=5, max_new=40)
    eos.eos_token = ex.expected_tokens(eos.prompt, 40)[3]
    for r in (first, second, eos):
        eng.submit(r)
    eng.submit(migrated, front=True)
    run.drain(eng)
    assert len(eos.out_tokens) == 4


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_eviction_refill, sc_oom_preemption, sc_priority_victim,
    sc_sole_resident_oom, sc_decode_fault, sc_prefill_fault, sc_device_loss,
    sc_fixed_scheduler, sc_long_request, sc_pages_per_eviction,
    sc_front_submit_and_eos)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stub_scenarios_match_reference_engine(name):
    results = {}
    for pkg in ("ref", "port"):
        run = _Run(pkg)
        SCENARIOS[name](run)
        results[pkg] = run.result()
        for r in run.reqs:      # the stub's closed-form oracle
            if r.done:
                assert r.out_tokens == PKGS[pkg]["serving"].StubExecutor \
                    .expected_tokens(r.prompt, r.max_new_tokens,
                                     eos_token=r.eos_token)
    ref_trace, ref_reqs = results["ref"]
    port_trace, port_reqs = results["port"]
    assert port_reqs == ref_reqs
    assert len(port_trace) == len(ref_trace)
    for i, (p, r) in enumerate(zip(port_trace, ref_trace)):
        assert p == r, f"step {i}"


def test_engine_refuses_bad_arguments_as_the_reference_does():
    ctx = PKGS["port"]["context"]()
    with pytest.raises(terrors.InvalidArgError):
        tserving.ServingEngine(None, None, batch_slots=1, max_seq=16,
                               executor=tserving.StubExecutor(1, 16),
                               scheduler="magic", context=ctx)
    with pytest.raises(terrors.InvalidArgError):
        tserving.ServingEngine(None, None, batch_slots=2, max_seq=16,
                               executor=tserving.StubExecutor(4, 16),
                               context=ctx)
    with pytest.raises(terrors.InvalidArgError, match="fusion"):
        ctx.create_queue(fusion="sometimes")


def test_queue_dag_orders_and_fails_typed():
    ctx = PKGS["port"]["context"]()
    q = ctx.create_queue(out_of_order=True, workers=4)
    seen = []
    a = q.enqueue_native(lambda: seen.append("a"), name="a")
    b = q.enqueue_native(lambda: seen.append("b"), wait_for=[a], name="b")
    bar = q.enqueue_barrier()
    c = q.enqueue_native(lambda: seen.append("c"), name="c")

    def boom():
        raise terrors.DeviceLostError("x")
    d = q.enqueue_native(boom, name="d")
    e = q.enqueue_native(lambda: seen.append("e"), wait_for=[d], name="e")
    with pytest.raises(trt.CommandError):
        q.finish(timeout=30)
    assert seen.index("a") < seen.index("b") < seen.index("c")
    assert bar.succeeded and c.succeeded and b.succeeded
    assert isinstance(d.error, terrors.DeviceLostError)
    assert isinstance(e.error, trt.DependencyError) and "e" not in seen
    assert q.dag_stats() == {"mode": "flush", "fused_chains": 0,
                             "commands_eliminated": 0, "bytes_elided": 0}
    gate = trt.UserEvent()
    f = q.enqueue_native(lambda: None, wait_for=[gate])
    q.flush()
    assert q.cancel_pending() == [f] and f.failed


# ---------------------------------------------------------------------------
# TorchExecutor at the smoke config (CPU)
# ---------------------------------------------------------------------------

def _params(dtype, seed):
    jcfg = jconfigs.get_smoke(ARCH, dtype=dtype)
    tcfg = tconfigs.get_smoke(ARCH, dtype=dtype)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg)


def _cpu_engine(tcfg, tp, slots, max_seq, **kw):
    return tserving.ServingEngine(tcfg, tp, batch_slots=slots,
                                  max_seq=max_seq,
                                  context=PKGS["port"]["context"](), **kw)


def _teacher_forced(tcfg, tp, prompt, n, max_seq):
    """The port's serial oracle: each next token is the greedy pick of a
    fresh prefill over everything so far."""
    toks = list(int(t) for t in prompt)
    with torch.inference_mode():
        for _ in range(n):
            logits, _, _ = forward(tp, torch.tensor([toks]), tcfg,
                                   caches=init_caches(tcfg, 1, max_seq),
                                   mode="prefill")
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_engine_greedy_matches_teacher_forced():
    _, tcfg, _, tp = _params("bfloat16", 0)
    eng = _cpu_engine(tcfg, tp, 2, 64)
    assert isinstance(eng._exec, tserving.TorchExecutor)
    prompt = np.arange(6, dtype=np.int32) + 3
    done = eng.generate([tserving.Request(prompt=prompt, max_new_tokens=5)])
    assert len(done) == 1
    assert done[0].out_tokens == _teacher_forced(tcfg, tp, prompt, 5, 64)
    st = eng.compile_stats
    assert st["prefill_calls"] == 1 and st["decode_steps"] == 4


def test_streams_do_not_depend_on_co_tenants():
    """Staggered arrivals over 2 slots give every request the stream it
    gets alone on an engine of the same width."""
    _, tcfg, _, tp = _params("bfloat16", 0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab, int(n)).astype(np.int32)
               for n in (4, 6, 5, 9)]
    budgets = [3, 5, 2, 4]
    alone = []
    serial = _cpu_engine(tcfg, tp, 2, 32)
    for p, m in zip(prompts, budgets):
        r = tserving.Request(prompt=p.copy(), max_new_tokens=m)
        serial.generate([r])
        alone.append(r.out_tokens)
    eng = _cpu_engine(tcfg, tp, 2, 32)
    reqs = [tserving.Request(prompt=p.copy(), max_new_tokens=m)
            for p, m in zip(prompts, budgets)]
    pending = list(reqs)
    while pending or eng.scheduler_stats["waiting"] or \
            eng.scheduler_stats["running"]:
        if pending:
            eng.submit(pending.pop(0))
        eng.step()
    assert [r.out_tokens for r in reqs] == alone


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 3e-2), ("float32", 1e-5)])
def test_torch_executor_matches_jax_executor(dtype, tol):
    jcfg, tcfg, jp, tp = _params(dtype, 1)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab, int(n)).astype(np.int32)
               for n in (5, 11, 3, 8)]
    budgets = [6, 4, 7, 5]

    def serve(eng, Request):
        reqs = [Request(prompt=p.copy(), max_new_tokens=m)
                for p, m in zip(prompts, budgets)]
        pending = list(reqs)
        while pending or eng.scheduler_stats["waiting"] or \
                eng.scheduler_stats["running"]:
            if pending and eng.current_step % 2 == 0:
                eng.submit(pending.pop(0))
            eng.step()
        return [r.out_tokens for r in reqs]

    ref = serve(jserving.ServingEngine(jcfg, jp, BASELINE_RULES,
                                       batch_slots=2, max_seq=32,
                                       context=jrt.Context()),
                jserving.Request)
    got = serve(_cpu_engine(tcfg, tp, 2, 32), tserving.Request)
    for p, r_stream, t_stream in zip(prompts, ref, got):
        assert len(t_stream) == len(r_stream)
        if t_stream == r_stream:
            continue
        # the streams part at the first differing step: allowed only
        # where the reference's own top-two logits are a near-tie
        k = next(j for j, (a, b) in enumerate(zip(r_stream, t_stream))
                 if a != b)
        seq = list(int(t) for t in p) + list(r_stream)
        logits, _, _ = jforward(jp, jnp.asarray([seq], jnp.int32), jcfg,
                                BASELINE_RULES, mode="train")
        top2 = np.sort(np.asarray(logits[0, len(p) - 1 + k]
                                  .astype(jnp.float32)))[-2:]
        assert top2[1] - top2[0] < tol, (p.tolist(), k, r_stream, t_stream)


def test_serve_cli_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    assert len(out["done"]) == 3 and all(r.done for r in out["done"])
    assert out["tokens"] == sum(len(r.out_tokens) for r in out["done"])
    assert out["device"] == "cpu"
    text = capsys.readouterr().out
    assert text.startswith("served 3 requests")
    assert "kv pool:" in text and "sched:" in text


def test_serve_cli_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(trt.DeviceNotFoundError):
        tserve.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(trt.DeviceNotFoundError):
        trt.default_context()


def test_make_requests_draws_in_the_given_ranges():
    cfg = tconfigs.get_config(ARCH)
    reqs = tserve.make_requests(cfg, np.random.default_rng(0), 50,
                                (32, 512), (32, 128))
    lens = [len(r.prompt) for r in reqs]
    news = [r.max_new_tokens for r in reqs]
    assert 32 <= min(lens) and max(lens) <= 512
    assert 32 <= min(news) and max(news) <= 128
    assert all(0 <= int(r.prompt.max()) < cfg.vocab for r in reqs)


def test_torch_executor_state_and_footprint():
    _, tcfg, _, _ = _params("bfloat16", 0)
    tp = init_params(tcfg, torch.Generator().manual_seed(0))
    ex = tserving.TorchExecutor(tcfg, tp, batch_slots=3, max_seq=16)
    st = ex.init_state()
    assert st["k"].shape == (2, 3, 2, 16, 16) and st["k"].dtype == \
        torch.bfloat16
    assert ex.cache_bytes(3, 16) == sum(t.numel() * t.element_size()
                                        for t in st.values())
    frag, tok = ex.prefill(np.array([5, 6, 7], np.int32), 1)
    assert frag["len"].tolist() == [3] and 0 <= tok < tcfg.vocab
    assert ex.bucket(3) == 8 and ex.bucket(9) == 16 and ex.bucket(100) == 16
    st = ex.insert(st, frag, 1)
    assert st["len"].tolist() == [0, 3, 0]
    assert torch.equal(st["k"][:, 1], frag["k"][:, 0])
    st, out = ex.decode(st, np.array([0, tok, 0]),
                        np.array([False, True, False]))
    assert st["len"].tolist() == [0, 4, 0] and out.shape == (3,)


def test_step_functions_are_the_forward():
    from repro_torch.serving.steps import make_decode_step, make_prefill_step
    tcfg = tconfigs.get_smoke(ARCH)
    tp = init_params(tcfg, torch.Generator().manual_seed(5))
    toks = torch.randint(0, tcfg.vocab, (2, 7),
                         generator=torch.Generator().manual_seed(6))
    last, caches = make_prefill_step(tcfg)(tp, {"tokens": toks},
                                           init_caches(tcfg, 2, 16))
    want, _, _ = forward(tp, toks, tcfg, caches=init_caches(tcfg, 2, 16),
                         mode="prefill")
    assert torch.equal(last, want[:, -1])
    tok, caches = make_decode_step(tcfg)(
        tp, {"tokens": last.argmax(-1)[:, None]}, caches)
    assert tok.dtype == torch.int32 and tok.shape == (2,)
    assert caches["len"].tolist() == [8, 8]


# ---------------------------------------------------------------------------
# the ssm family (mamba2-780m smoke) through TorchExecutor
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-780m"


def _ssm_params(dtype, seed):
    jcfg = jconfigs.get_smoke(SSM_ARCH, dtype=dtype)
    tcfg = tconfigs.get_smoke(SSM_ARCH, dtype=dtype)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg)


def _same_or_near_tie(got, want, prompt, logits_of, tol):
    """``got`` equals ``want``, or the two part at a step where the logits
    behind ``want`` (``logits_of(tokens)`` over the prompt and ``want``'s
    tokens before it, no cache) put their top two within ``tol``: there
    two frameworks, or two formulations of one scan, may rightly pick
    different tokens."""
    assert len(got) == len(want)
    if got == want:
        return
    k = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    top2 = np.sort(logits_of(list(prompt) + list(want[:k]))[-1])[-2:]
    assert top2[1] - top2[0] < tol, (list(prompt), k, want, got)


def _port_logits(tcfg, tp):
    def run(seq):
        with torch.inference_mode():
            logits, _, _ = forward(tp, torch.tensor([seq]), tcfg)
        return logits[0].float().numpy()
    return run


def _ref_logits(jcfg, jp):
    def run(seq):
        logits, _, _ = jforward(jp, jnp.asarray([seq], jnp.int32), jcfg,
                                BASELINE_RULES, mode="train")
        return np.asarray(logits[0].astype(jnp.float32))
    return run


def _greedy(logits_of, prompt, n):
    """The teacher-forced stream: each next token the greedy pick of a
    forward without a cache over everything so far."""
    toks = [int(t) for t in prompt]
    for _ in range(n):
        toks.append(int(np.argmax(logits_of(toks)[-1])))
    return toks[len(prompt):]


@pytest.mark.parametrize("plen", [1, 2, 5, 8, 13])
def test_mamba2_served_streams_equal_teacher_forced(plen):
    """The engine prefills each prompt at its exact length and decodes
    from the state it leaves: the streams equal the teacher-forced
    forward without a cache, the port's own and the reference's
    (float32, where the two differ by rounding only)."""
    jcfg, tcfg, jp, tp = _ssm_params("float32", 2)
    prompt = np.random.default_rng(100 + plen).integers(
        0, tcfg.vocab, plen).astype(np.int32)
    eng = _cpu_engine(tcfg, tp, 2, 64)
    req = tserving.Request(prompt=prompt.copy(), max_new_tokens=5)
    eng.generate([req])
    assert req.done and len(req.out_tokens) == 5
    st = eng.compile_stats
    assert st["prefill_calls"] == 1 and st["prefill_shapes"] == 1
    port, ref = _port_logits(tcfg, tp), _ref_logits(jcfg, jp)
    _same_or_near_tie(req.out_tokens, _greedy(port, prompt, 5), prompt,
                      port, 1e-5)
    _same_or_near_tie(req.out_tokens, _greedy(ref, prompt, 5), prompt, ref,
                      1e-5)


def test_mamba2_streams_do_not_depend_on_co_tenants():
    _, tcfg, _, tp = _ssm_params("bfloat16", 3)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab, int(n)).astype(np.int32)
               for n in (3, 9, 1, 6)]
    budgets = [4, 3, 5, 2]
    alone = []
    for p, m in zip(prompts, budgets):
        r = tserving.Request(prompt=p.copy(), max_new_tokens=m)
        _cpu_engine(tcfg, tp, 2, 32).generate([r])
        alone.append(r.out_tokens)
    eng = _cpu_engine(tcfg, tp, 2, 32)
    reqs = [tserving.Request(prompt=p.copy(), max_new_tokens=m)
            for p, m in zip(prompts, budgets)]
    pending = list(reqs)
    while pending or eng.scheduler_stats["waiting"] or \
            eng.scheduler_stats["running"]:
        if pending:
            eng.submit(pending.pop(0))
        eng.step()
    assert [r.out_tokens for r in reqs] == alone


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2.0 ** -4),
                                       ("float32", 1e-5)])
def test_mamba2_torch_executor_matches_jax_executor(dtype, tol):
    """Only on prompts whose length is its own bucket and a multiple of
    ``ssm_chunk`` (8 and 16): elsewhere the reference's padded prefill
    folds its padding into the state (ROADMAP C.5).  A near-tie of the
    reference's top two logits (within the model tests' logits
    tolerance) may part the streams."""
    jcfg, tcfg, jp, tp = _ssm_params(dtype, 1)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, tcfg.vocab, int(n)).astype(np.int32)
               for n in (8, 16, 8)]
    budgets = [5, 4, 6]

    def serve(eng, Request):
        reqs = [Request(prompt=p.copy(), max_new_tokens=m)
                for p, m in zip(prompts, budgets)]
        pending = list(reqs)
        while pending or eng.scheduler_stats["waiting"] or \
                eng.scheduler_stats["running"]:
            if pending and eng.current_step % 2 == 0:
                eng.submit(pending.pop(0))
            eng.step()
        return [r.out_tokens for r in reqs]

    jeng = jserving.ServingEngine(jcfg, jp, BASELINE_RULES, batch_slots=2,
                                  max_seq=32, context=jrt.Context())
    assert all(jeng._exec.bucket(len(p)) == len(p) for p in prompts)
    ref = serve(jeng, jserving.Request)
    got = serve(_cpu_engine(tcfg, tp, 2, 32), tserving.Request)
    for p, r_stream, t_stream in zip(prompts, ref, got):
        _same_or_near_tie(t_stream, r_stream, p, _ref_logits(jcfg, jp), tol)


@pytest.mark.parametrize("arch", [ARCH, SSM_ARCH] + [
    a for a in jconfigs.ARCH_IDS if a not in (ARCH, SSM_ARCH)])
def test_cache_bytes_equal_the_jax_executors(arch):
    """The page sizing reads ``cache_bytes``: it is the sum over every
    cache leaf, as the reference's, for every family."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    tp = init_params(tcfg, torch.Generator().manual_seed(0))
    tex = tserving.TorchExecutor(tcfg, tp, batch_slots=2, max_seq=16)
    jex = jexecutor.JaxExecutor(jcfg, jinit_params(jcfg,
                                                   jax.random.PRNGKey(0)),
                                BASELINE_RULES, batch_slots=2, max_seq=16)
    for batch, seq in ((1, 16), (3, 64), (8, 2048)):
        assert tex.cache_bytes(batch, seq) == jex.cache_bytes(batch, seq), \
            (arch, batch, seq)
    st = tex.init_state()
    assert tex.cache_bytes(2, 16) == sum(t.numel() * t.element_size()
                                         for t in st.values())


def test_mamba2_executor_prefills_at_the_exact_length():
    _, tcfg, _, _ = _ssm_params("bfloat16", 0)
    tp = init_params(tcfg, torch.Generator().manual_seed(0))
    ex = tserving.TorchExecutor(tcfg, tp, batch_slots=3, max_seq=16)
    st = ex.init_state()
    assert st["ssd"].shape == (2, 3, 8, 16, 16)
    assert st["ssd"].dtype == torch.float32
    assert st["conv_x"].shape == (2, 3, 3, 128)
    for n in (3, 5, 3, 9):
        frag, tok = ex.prefill(np.arange(n, dtype=np.int32) + 1, 0)
        assert frag["len"].tolist() == [n] and 0 <= tok < tcfg.vocab
    assert ex.compile_stats()["prefill_shapes"] == 3     # 3, 5 and 9
    st = ex.insert(st, frag, 2)
    assert st["len"].tolist() == [0, 0, 9]
    assert torch.equal(st["ssd"][:, 2], frag["ssd"][:, 0])
    st, out = ex.decode(st, np.array([0, 0, tok]),
                        np.array([False, False, True]))
    assert st["len"].tolist() == [0, 0, 10] and out.shape == (3,)


def test_serve_cli_mamba2_on_cpu(capsys):
    out = tserve.main(["--arch", SSM_ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    assert len(out["done"]) == 3 and all(r.done for r in out["done"])
    assert out["device"] == "cpu"
    assert capsys.readouterr().out.startswith("served 3 requests")


# ---------------------------------------------------------------------------
# the hybrid, vlm and encdec families through TorchExecutor
# ---------------------------------------------------------------------------

def _family_params(arch, dtype, seed):
    """Smoke params of ``arch`` for both packages; a vlm's cross-attention
    gates drawn from N(0, 1) (zeros at init: the image would reach no
    logit)."""
    jcfg = jconfigs.get_smoke(arch, dtype=dtype)
    tcfg = tconfigs.get_smoke(arch, dtype=dtype)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    if jcfg.family == "vlm":
        jp["cross"]["gate"] = jnp.asarray(np.random.default_rng(seed).normal(
            size=jp["cross"]["gate"].shape), jnp.float32)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg)


def _serve_both(jcfg, tcfg, jp, tp, prompts, budgets, aux, slots=2):
    def serve(eng, Request):
        reqs = [Request(prompt=p.copy(), max_new_tokens=m)
                for p, m in zip(prompts, budgets)]
        pending = list(reqs)
        while pending or eng.scheduler_stats["waiting"] or \
                eng.scheduler_stats["running"]:
            if pending and eng.current_step % 2 == 0:
                eng.submit(pending.pop(0))
            eng.step()
        return [r.out_tokens for r in reqs]

    jeng = jserving.ServingEngine(jcfg, jp, BASELINE_RULES, batch_slots=slots,
                                  max_seq=32, aux_inputs=aux,
                                  context=jrt.Context())
    teng = _cpu_engine(tcfg, tp, slots, 32, aux_inputs=aux)
    return jeng, serve(jeng, jserving.Request), serve(teng, tserving.Request)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_torch_executor_with_aux_inputs_matches_jax_executor(arch):
    """Image or frame embeddings, one row per slot (the reference's
    ``launch/serve.py`` draws them so): a prefill reads its slot's row, a
    decode step every row.  Float32, where the two differ by rounding;
    a near-tie of the reference's top two logits may part the streams."""
    jcfg, tcfg, jp, tp = _family_params(arch, "float32", 4)
    rng = np.random.default_rng(13)
    aux = tserve.make_aux_inputs(tcfg, rng, 2)
    assert set(aux) == ({"img_embeds"} if tcfg.family == "vlm"
                        else {"frames"})
    prompts = [rng.integers(0, tcfg.vocab, int(n)).astype(np.int32)
               for n in (5, 11, 3, 8)]
    budgets = [6, 4, 7, 5]
    _, ref, got = _serve_both(jcfg, tcfg, jp, tp, prompts, budgets, aux)
    for p, r_stream, t_stream in zip(prompts, ref, got):
        assert len(t_stream) == len(r_stream)
        if t_stream == r_stream:
            continue
        k = next(j for j, (a, b) in enumerate(zip(r_stream, t_stream))
                 if a != b)
        # the slot the request ran in is not known here: the near-tie is
        # looked for under every row's inputs
        seq = jnp.asarray([list(int(t) for t in p) + list(r_stream)],
                          jnp.int32)
        gaps = []
        for row in range(2):
            a = {key: jnp.asarray(v[row:row + 1]) for key, v in aux.items()}
            lg, _, _ = jforward(jp, seq, jcfg, BASELINE_RULES, aux_inputs=a,
                                mode="train")
            top2 = np.sort(np.asarray(lg[0, len(p) - 1 + k]))[-2:]
            gaps.append(top2[1] - top2[0])
        assert min(gaps) < 1e-5, (p.tolist(), k, r_stream, t_stream)


def test_encdec_enc_out_carries_from_prefill_into_decode():
    """The prefill's fragment holds the encoder's output of its slot's
    frames; insert puts it in the slot's row of the batch cache (in the
    cache's bfloat16), and decode reads it there: a zeroed row changes
    that slot's next token logits."""
    _, tcfg, _, tp = _family_params("whisper-small", "float32", 5)
    aux = tserve.make_aux_inputs(tcfg, np.random.default_rng(5), 2)
    ex = tserving.TorchExecutor(tcfg, tp, batch_slots=2, max_seq=32,
                                aux_inputs=aux)
    st = ex.init_state()
    assert st["enc_out"].shape == (2, tcfg.enc_seq, tcfg.d_model)
    frag, tok = ex.prefill(np.arange(6, dtype=np.int32) + 1, 1)
    assert frag["enc_out"].shape == (1, tcfg.enc_seq, tcfg.d_model)
    with torch.inference_mode():
        from repro_torch.models.model import _encode_audio
        want = _encode_audio(ex.params, torch.as_tensor(aux["frames"][1:2]),
                             tcfg)
    torch.testing.assert_close(frag["enc_out"], want)
    st = ex.insert(st, frag, 1)
    assert torch.equal(st["enc_out"][1], frag["enc_out"][0].to(torch.bfloat16))
    assert not bool(st["enc_out"][0].any())
    kept = {k: v.clone() for k, v in st.items()}
    _, out = ex.decode(st, np.array([0, tok]), np.array([False, True]))
    kept["enc_out"][1] = 0
    with torch.inference_mode():
        a, _, _ = forward(ex.params, torch.tensor([[0], [tok]]), tcfg,
                          aux_inputs=ex.aux, caches={k: v.clone() for k, v
                                                     in st.items()},
                          mode="decode")
    assert out.shape == (2,)
    with torch.inference_mode():
        z, _, _ = forward(ex.params, torch.tensor([[0], [tok]]), tcfg,
                          aux_inputs=ex.aux, caches=kept, mode="decode")
    assert float((a[1] - z[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2.0 ** -4),
                                       ("float32", 1e-5)])
def test_hybrid_torch_executor_matches_jax_executor(dtype, tol):
    """zamba2's smoke model on prompts whose length is its own bucket and
    a multiple of ``ssm_chunk`` (8 and 16), where the reference's padded
    prefill is exact (ROADMAP C.5); a near-tie of the reference's top two
    logits may part the streams."""
    jcfg, tcfg, jp, tp = _family_params("zamba2-7b", dtype, 1)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, tcfg.vocab, int(n)).astype(np.int32)
               for n in (8, 16, 8)]
    budgets = [5, 4, 6]
    jeng, ref, got = _serve_both(jcfg, tcfg, jp, tp, prompts, budgets, {})
    assert all(jeng._exec.bucket(len(p)) == len(p) for p in prompts)
    for p, r_stream, t_stream in zip(prompts, ref, got):
        _same_or_near_tie(t_stream, r_stream, p, _ref_logits(jcfg, jp), tol)


@pytest.mark.parametrize("plen", [1, 5, 13])
def test_hybrid_executor_prefills_at_the_exact_length(plen):
    """A hybrid prompt is prefilled at its exact length (its mamba states
    would take in padding), and the stream equals the teacher-forced
    forward without a cache."""
    _, tcfg, _, tp = _family_params("zamba2-7b", "float32", 2)
    prompt = np.random.default_rng(200 + plen).integers(
        0, tcfg.vocab, plen).astype(np.int32)
    eng = _cpu_engine(tcfg, tp, 2, 64)
    req = tserving.Request(prompt=prompt.copy(), max_new_tokens=4)
    eng.generate([req])
    assert req.done and len(req.out_tokens) == 4
    assert eng._exec._prefill_shapes == {plen}
    port = _port_logits(tcfg, tp)
    # the served decode reads bfloat16 keys, the forward float32 ones
    _same_or_near_tie(req.out_tokens, _greedy(port, prompt, 4), prompt,
                      port, 1e-2)


def test_serve_cli_runs_every_architecture_on_cpu(capsys):
    for arch in tconfigs.ARCH_IDS:
        out = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "2", "--max-new", "3"])
        assert len(out["done"]) == 2 and all(r.done for r in out["done"]), \
            arch
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "gpt-9", "--smoke", "--device", "cpu"])
