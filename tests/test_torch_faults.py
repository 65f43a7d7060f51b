"""The port's fault handling (``runtime.faults``, the scheduler's admission,
shedding and preemption, the engine's preemption and recompute, NaN
quarantine, watchdog recovery, deadlines and cancellation) vs the JAX
package, on the smoke TinyLlama config in fp32 on the CPU, with the same
params (``bridge.params_from_numpy``) and the same seeded requests:

* ``parse_fault``, ``FaultPlan.at``, ``poison_row`` and ``p=`` firing over
  steps 0..199 equal the reference's for a list of specs;
* the scheduler's admission, priority order, shed victims, ``requeue``
  order, preemption victims and ``pop_expired`` equal the reference's over
  seeded request streams (hypothesis);
* greedy streams, finish reasons and the counters ``errors``,
  ``recoveries``, ``preemptions``, ``timeouts``, ``shed`` equal the JAX
  engine's under the CI chaos plans (contiguous and paged), a starved page
  pool, ``admission="preempt"``, a deadline and ``max_waiting``;
* sampled streams after preemption and after watchdog recovery equal the
  port's own fault-free streams;
* ``runtime.graphs.StepGraphs``: a body that raises on its first call, or
  a capture that raises, leaves the key unregistered; a ``nan`` fault runs
  the step keys a clean run has (the poison is a float32 input of every
  key); ``cancel()`` frees the slot and its pages; the launcher's chaos
  lines exit 0.
"""
import dataclasses
import functools
import time

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke_config as j_smoke
from repro.models import registry as jR
from repro.runtime import faults as jfaults
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSampling
from repro.serving.scheduler import FCFSScheduler as JScheduler
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models import bridge
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import graphs
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSampling
from repro_torch.serving.scheduler import FCFSScheduler as TScheduler

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its smoke-sized steps
    gain nothing from more, and beside the rest of the suite on several
    workers every parallel region would wait for threads that the other
    workers hold (the module ran 15-100x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# -- FaultPlan ---------------------------------------------------------------

_SPECS = ["nan:step=3", "nan:step=3,slot=1", "nan:p=0.05", "fail:step=7",
          "fail:step=5,every=10", "delay:step=5,s=0.2",
          "delay:p=0.1,s=0.002", "die:step=3", "flip:step=3,leaf=2,bit=17",
          "nan:p=0.3,slot=3", "fail:p=0.02"]
_BAD = ["oops:step=1", "nan", "nan:step=1,p=0.5", "delay:step=1",
        "nan:step=x", "nan:foo=1", "nan:step="]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_fault_matches_reference(spec):
    assert dataclasses.asdict(tfaults.parse_fault(spec)) == \
        dataclasses.asdict(jfaults.parse_fault(spec))


@pytest.mark.parametrize("spec", _BAD)
def test_bad_fault_specs_refused_as_reference(spec):
    with pytest.raises(ValueError):
        jfaults.parse_fault(spec)
    with pytest.raises(ValueError):
        tfaults.parse_fault(spec)


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_firing_matches_reference(seed):
    tp = tfaults.FaultPlan.parse(_SPECS, seed=seed)
    jp = jfaults.FaultPlan.parse(_SPECS, seed=seed)
    assert bool(tp) and not tfaults.FaultPlan()
    fired = 0
    for step in range(200):
        got = [dataclasses.asdict(f) for f in tp.at(step)]
        assert got == [dataclasses.asdict(f) for f in jp.at(step)], step
        fired += len(got)
        tr, jr = tp.poison_row(step, 4), jp.poison_row(step, 4)
        assert (tr is None) == (jr is None), step
        if tr is not None:
            assert tr.dtype == jr.dtype == np.float32
            np.testing.assert_array_equal(np.isnan(tr), np.isnan(jr))
    assert fired > 20
    assert tfaults.DIE_EXIT_CODE == jfaults.DIE_EXIT_CODE


def test_raise_or_delay_raises_at_the_fail_step():
    plan = tfaults.FaultPlan.parse(["fail:step=2"])
    plan.raise_or_delay(1)
    with pytest.raises(tfaults.InjectedFault, match="step 2"):
        plan.raise_or_delay(2)


# -- the scheduler -----------------------------------------------------------

def _sched_trace(make_sched, make_req, seed: int) -> list:
    """One seeded stream of adds, schedules (with a simulated slot table),
    preemption requeues, page-gate requeues, expiries and removals; every
    observable outcome recorded."""
    rng = np.random.default_rng(seed)
    admission = ("reject", "truncate", "preempt")[seed % 3]
    sched = make_sched(admission, int(rng.integers(1, 4)) if seed % 2
                       else None)
    slots: list = [None] * 3
    done = [0] * 3
    live: list = []
    trace = []
    rid = 0
    for _ in range(40):
        op = rng.integers(0, 6)
        if op <= 1:
            r = make_req(rid, np.ones(int(rng.integers(1, 40)), np.int32),
                         max_new_tokens=int(rng.integers(1, 40)),
                         priority=int(rng.integers(0, 3)))
            if rng.random() < 0.3:
                r.deadline_s = 1e-9
            r.t_submit = 1.0
            rid += 1
            live.append(r)
            trace.append(("add", r.rid, sched.add(r), r.finish_reason,
                          r.max_new_tokens))
        elif op == 2:
            running = [(i, slots[i], done[i]) for i in range(3) if slots[i]]
            free = [i for i in range(3) if slots[i] is None]
            so = sched.schedule(running, free,
                                token_budget=int(rng.integers(2, 20)))
            trace.append(("sched", so.decode_slots, so.preempt_slots,
                          [(c.slot, c.req.rid, c.start, c.length, c.last)
                           for c in so.chunks], so.n_scheduled_tokens))
            for i in so.preempt_slots:
                trace.append(("requeue", slots[i].rid,
                              sched.requeue(slots[i]),
                              slots[i].finish_reason))
                slots[i], done[i] = None, 0
            for c in so.chunks:
                if rng.random() < 0.2 and c.start == 0:
                    # the page gate sends an ungranted new prompt back
                    trace.append(("requeue", c.req.rid, sched.requeue(c.req),
                                  c.req.finish_reason))
                    continue
                slots[c.slot] = c.req
                done[c.slot] = c.start + c.length
        elif op == 3:
            i = int(rng.integers(0, 3))
            slots[i], done[i] = None, 0     # a running request finished
        elif op == 4:
            trace.append(("expired", [r.rid for r in
                                      sched.pop_expired(2.0)]))
        elif live:
            r = live[int(rng.integers(0, len(live)))]
            trace.append(("remove", r.rid, sched.remove(r)))
        trace.append(("state", len(sched), sched.backpressure,
                      [(r.rid, r.finish_reason) for r in sched.shed]))
        sched.shed.clear()
    trace.append(("pop_all", [r.rid for r in sched.pop_all()]))
    return trace


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_scheduler_matches_reference(seed):
    got = _sched_trace(
        lambda a, w: TScheduler(48, chunk_size=8, admission=a,
                                max_waiting=w, page_size=8, total_pages=5),
        TRequest, seed)
    want = _sched_trace(
        lambda a, w: JScheduler(48, chunk_size=8, admission=a,
                                max_waiting=w, page_size=8, total_pages=5),
        JRequest, seed)
    assert got == want


# -- the engine vs the JAX engine --------------------------------------------

def _fused(cfg):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, exec_path="fused"))


@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg = _fused(j_smoke("tinyllama_1_1b"))
    tcfg = _fused(t_smoke("tinyllama_1_1b"))
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


def _launcher_requests(sampled, n=6, max_new=8, buffer=128):
    """The requests ``launch.serve`` submits (seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for rid in range(n):
        plen = int(rng.integers(4, buffer // 4))
        sp = dict(temperature=0.8, top_k=20, seed=rid) if sampled else {}
        out.append((rid, rng.integers(0, 512, plen, dtype=np.int32),
                    max_new, sp))
    return out


def _sampled(sampled, rid):
    return (dict(temperature=0.7, top_k=8, seed=11 + rid)
            if sampled and rid % 2 == 0 else {})


def _preempt_requests(sampled, n=2, plen=10, max_new=6):
    rng = np.random.default_rng(3)
    return [(rid, rng.integers(0, 512, plen, dtype=np.int32), max_new,
             _sampled(sampled, rid)) for rid in range(n)]


_COUNTERS = ("errors", "recoveries", "preemptions", "timeouts", "shed",
             "completed", "rejected")


def _drive(eng, make, sampling, specs, late=None, deadline=None):
    """Submit ``specs`` ((rid, prompt, max_new, sampling kw)), step until
    both slots decode when ``late`` is given, then submit the late
    high-priority request, and drain."""
    admitted = []
    for rid, prompt, max_new, sp in specs:
        r = make(rid, prompt, max_new_tokens=max_new, sampling=sampling(**sp),
                 deadline_s=deadline if rid == 0 else None)
        admitted.append(eng.add_request(r))
    if late is not None:
        for _ in range(4):
            eng.step()
        rid, prompt, max_new, sp = late
        eng.submit(make(rid, prompt, max_new_tokens=max_new, priority=5,
                        sampling=sampling(**sp)))
    eng.run_until_drained(max_steps=500)
    outs = {o.rid: (o.finish_reason, list(o.tokens), o.preemptions)
            for o in eng.outputs()}
    return outs, {k: getattr(eng.stats, k) for k in _COUNTERS}, admitted


_CASES = {
    "ci chaos, contiguous": dict(
        eng=dict(batch_slots=4, buffer_len=128),
        specs=_launcher_requests, faults=["nan:step=3", "fail:step=7"]),
    "ci chaos, paged": dict(
        eng=dict(batch_slots=4, buffer_len=128, paged=True),
        specs=_launcher_requests, faults=["nan:step=3", "fail:step=7"]),
    "ci chaos, packed": dict(
        eng=dict(batch_slots=4, buffer_len=128, packed=True),
        specs=_launcher_requests, faults=["nan:step=3,slot=1",
                                          "fail:step=5"]),
    "starved page pool": dict(
        eng=dict(batch_slots=2, buffer_len=32, paged=True, page_size=4,
                 kv_pages=8, admission="preempt"),
        specs=lambda sampled: [(j, np.arange(1, 5 + 2 * j,
                                             dtype=np.int32) * 7, 14,
                                _sampled(sampled, j)) for j in range(3)]),
    "admission preempt": dict(
        eng=dict(batch_slots=2, buffer_len=64, admission="preempt"),
        specs=_preempt_requests, late=(9, np.arange(3, 13, dtype=np.int32),
                                       4, {})),
    "deadline": dict(
        eng=dict(batch_slots=2, buffer_len=64), specs=_preempt_requests,
        deadline=1e-6),
    "max_waiting": dict(
        eng=dict(batch_slots=2, buffer_len=64, max_waiting=2),
        specs=lambda sampled: _preempt_requests(sampled, n=4, max_new=2)),
}


def _case_run(case, port: bool, sampled: bool = False, faults=True):
    jcfg, tcfg, jparams, tparams = _smoke()
    c = _CASES[case]
    kw = dict(chunk_size=8, **c["eng"])
    plan = c.get("faults") if faults else None
    specs = c["specs"](sampled)
    if port:
        eng = TEngine(tparams, tcfg, device="cpu",
                      faults=tfaults.FaultPlan.parse(plan) if plan else None,
                      **kw)
        make, sampling = TRequest, TSampling
    else:
        eng = JEngine(jparams, jcfg, use_mapper=False,
                      faults=jfaults.FaultPlan.parse(plan) if plan else None,
                      **kw)
        make, sampling = JRequest, JSampling
    return eng, _drive(eng, make, sampling, specs, c.get("late"),
                       c.get("deadline"))


@pytest.mark.parametrize("case", list(_CASES))
def test_engine_faults_match_reference(case):
    _je, want = _case_run(case, port=False)
    teng, got = _case_run(case, port=True)
    assert got == want
    outs, counters, _adm = got
    if "chaos" in case:
        assert counters["errors"] == 1 and counters["recoveries"] == 1
        assert sum(r == "error" for r, _t, _p in outs.values()) == 1
    if case in ("starved page pool", "admission preempt"):
        assert counters["preemptions"] >= 1
    if case == "deadline":
        assert counters["timeouts"] == 1 and outs[0][0] == "timeout"
    if case == "max_waiting":
        assert counters["shed"] == 2
    if teng.paged:
        assert teng.core.pager.used_pages == 0


@pytest.mark.parametrize("case", ["ci chaos, contiguous", "ci chaos, paged",
                                  "starved page pool", "admission preempt"])
def test_recompute_keeps_the_streams(case):
    """Every stream a fault did not end equals the fault-free run's:
    greedy (held against the JAX engine above) and sampled, where the
    draws are the port's own."""
    _e, (clean, _c, _a) = _case_run(case, port=True, sampled=True,
                                    faults=False)
    eng, (outs, counters, _a) = _case_run(case, port=True, sampled=True)
    assert counters["recoveries"] + counters["preemptions"] >= 1
    assert len(outs) == len(clean)
    kept = {r: o[:2] for r, o in outs.items() if o[0] != "error"}
    assert kept == {r: clean[r][:2] for r in kept}
    if "chaos" in case:
        assert len(kept) == len(outs) - 1


def test_cancel_frees_slot_and_pages():
    _jcfg, tcfg, _jp, tparams = _smoke()
    eng = TEngine(tparams, tcfg, batch_slots=2, buffer_len=64, chunk_size=8,
                  paged=True, page_size=8, device="cpu")
    fins = []
    reqs = [TRequest(rid, np.arange(1, 12, dtype=np.int32), max_new_tokens=6,
                     on_finish=fins.append) for rid in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.step()                          # a first chunk a slot: 1 page each
    assert eng.core.pager.used_pages == 2
    assert eng.cancel(reqs[0]) and eng.cancel(reqs[2])
    assert eng.core.pager.used_pages == 1 and eng.slots[0] is None
    assert not eng.cancel(reqs[0])                  # finished once
    eng.run_until_drained()
    assert [(o.rid, o.finish_reason) for o in fins] == \
        [(0, "cancelled"), (2, "cancelled"), (1, "length")]
    assert eng.stats.cancelled == 2 and eng.core.pager.used_pages == 0


def test_stall_watchdog_commits_then_recovers(monkeypatch):
    """A step past ``step_timeout_s`` (an injected delay) is committed, then
    the core is rebuilt; the streams equal the run without the delay. The
    first call of every shape on every core is made slower than the
    timeout, as a CUDA-graph capture is on the card: the stall clock leaves
    it out (``StepGraphs.first_calls``), else every rebuilt core's first step
    would stall and rebuild again, without end. The timeout sits far above
    a smoke step on a loaded CPU: a timeout below the usual step time would
    stall every step and never drain."""
    from repro_torch.serving import core as tcore
    _e, (clean, _c, _a) = _case_run("ci chaos, packed", port=True,
                                    faults=False)
    body = tcore.EngineCore._packed_body
    slow: list = []

    def slow_first_call(self, a):
        # the packed shape of this call, first seen on this core
        seen = self.__dict__.setdefault("_seen_shapes", set())
        if a["tokens"].shape not in seen:
            seen.add(a["tokens"].shape)
            slow.append(a["tokens"].shape)
            time.sleep(0.6)
        return body(self, a)
    monkeypatch.setattr(tcore.EngineCore, "_packed_body", slow_first_call)
    _jcfg, tcfg, _jp, tparams = _smoke()
    eng = TEngine(tparams, tcfg, batch_slots=4, buffer_len=128, chunk_size=8,
                  packed=True, device="cpu", step_timeout_s=0.5,
                  faults=tfaults.FaultPlan.parse(["delay:step=4,s=0.8"]))
    outs, counters, _a = _drive(eng, TRequest, TSampling,
                                _launcher_requests(False))
    assert eng.stats.stalls >= 1 and counters["recoveries"] >= 1
    assert outs == clean
    # every slow first call, on the first core and the rebuilt ones, was
    # a warm-up off the stall clock
    assert eng.stats.warmups == len(slow) > counters["recoveries"]
    assert eng.stats.warmup_s >= 0.6 * len(slow)
    assert eng.stats.rebuild_s > 0.0


def test_drain_requests_strips_running_and_queued():
    _jcfg, tcfg, _jp, tparams = _smoke()
    eng = TEngine(tparams, tcfg, batch_slots=2, buffer_len=64, chunk_size=8,
                  paged=True, page_size=8, device="cpu")
    reqs = [TRequest(rid, np.arange(1, 12, dtype=np.int32), max_new_tokens=6,
                     priority=rid % 2) for rid in range(4)]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    running = [r.rid for r in eng.slots]
    assert running == [1, 3]                        # the priority-1 pair
    out = eng.drain_requests()
    assert [r.rid for r in out] == [1, 3, 0, 2]     # then the queue, FCFS
    assert eng.slots == [None, None] and len(eng.scheduler) == 0
    assert eng.core.pager.used_pages == 0
    # a stashed request carries its tokens in its prompt (recompute shape)
    r0 = out[0]
    assert r0.prompt_len == r0.prompt_len_orig + len(r0.out_tokens) > 11
    other = TEngine(tparams, tcfg, batch_slots=2, buffer_len=64,
                    chunk_size=8, device="cpu")
    for r in out:
        other.adopt(r)
    other.run_until_drained()
    assert sorted((o.rid, o.finish_reason, len(o.tokens))
                  for o in other.outputs()) == \
        [(rid, "length", 6) for rid in range(4)]


def test_pager_accounting_matches_reference():
    """``slot_pages``, ``release_all`` and ``total_bytes`` (the page gate's
    and recovery's bookkeeping) equal the reference pager's."""
    from repro.serving.kvcache import PagedKVCache as JPager
    from repro_torch.serving.kvcache import PagedKVCache as TPager
    pagers = [P(3, 4, 10, 4, page_bytes=96) for P in (JPager, TPager)]
    for slot, n in ((0, 5), (1, 9), (0, 13), (2, 3), (1, 16), (2, 12)):
        assert pagers[0].grant(slot, n) == pagers[1].grant(slot, n)
        assert pagers[0].slot_pages(slot) == pagers[1].slot_pages(slot)
    np.testing.assert_array_equal(pagers[0].page_table, pagers[1].page_table)
    assert pagers[1].total_bytes == pagers[0].total_bytes == 960
    used = pagers[1].used_pages
    assert used == pagers[0].used_pages > 0
    assert [p.release_all() for p in pagers] == [used, used]
    assert pagers[1].free_pages == pagers[0].free_pages == 10
    assert pagers[1].slot_pages(1) == () and pagers[1].used_bytes == 0


# -- graphs and the poison input ---------------------------------------------

def test_failing_first_call_leaves_no_key():
    sg = graphs.StepGraphs("cpu")
    calls = []

    def body(bufs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("first call fails")
        return (bufs["x"] * 2,)

    with pytest.raises(RuntimeError, match="first call"):
        sg.run("k", dict(x=np.arange(3)), body)
    assert not sg._entries
    out = sg.run("k", dict(x=np.arange(3)), body)
    assert out[0].tolist() == [0, 2, 4] and list(sg._entries) == ["k"]


def test_failing_capture_leaves_no_key_and_takes_counts_back(monkeypatch):
    """A capture that raises (simulated on the CPU) registers nothing and
    leaves the launch counters as the warm-up left them; the next call of
    the key captures again."""
    from repro_torch.kernels import ovsf_gemm as G
    sg = graphs.StepGraphs("cpu")
    sg.capture = True
    body = lambda bufs: (bufs["x"] + 1,)
    fails = [True]

    def capture(body_, bufs, pool):
        G.ovsf_gemm.launches += 5       # what a capture's wrappers count
        if fails.pop(0) if fails else False:
            raise torch.cuda.OutOfMemoryError("under capture")
        return "graph", body_(bufs)

    monkeypatch.setattr(sg, "_warm_up", lambda body_, bufs: body_(bufs))
    monkeypatch.setattr(sg, "_capture", capture)
    before = G.ovsf_gemm.launches
    with pytest.raises(torch.cuda.OutOfMemoryError):
        sg.run("k", dict(x=np.zeros(2)), body)
    assert not sg._entries and G.ovsf_gemm.launches == before
    sg.run("k", dict(x=np.zeros(2)), body)
    assert sg.keys() == ["k"] and sg._entries["k"].launches[0] == 5
    assert G.ovsf_gemm.launches == before


def test_nan_fault_runs_the_clean_step_keys():
    """The poison is a float32 static input of every step key, so a step
    with a nan fault is the same key (on the card: the same graph)."""
    _jcfg, tcfg, _jp, tparams = _smoke()
    keys = {}
    for name, plan in (("clean", None), ("nan", ["nan:step=2,slot=0",
                                                 "nan:step=4,slot=1"])):
        eng = TEngine(tparams, tcfg, batch_slots=4, buffer_len=64,
                      chunk_size=8, packed=True, device="cpu",
                      faults=tfaults.FaultPlan.parse(plan) if plan else None)
        seen = []
        run = eng.core.graphs.run
        eng.core.graphs.run = lambda k, inputs, body: (
            seen.append((k, inputs["poison"].dtype,
                         bool(np.isnan(inputs["poison"]).any()))),
            run(k, inputs, body))[1]
        for rid in range(4):
            eng.submit(TRequest(rid, np.arange(1, 6 + rid, dtype=np.int32),
                                max_new_tokens=5))
        eng.run_until_drained()
        keys[name] = seen
        assert all(e.bufs["poison"].dtype == torch.float32
                   for e in eng.core.graphs._entries.values())
    assert [k for k, _d, _n in keys["nan"]] == \
        [k for k, _d, _n in keys["clean"]]
    assert sum(n for _k, _d, n in keys["nan"]) == 2
    assert {d for _k, d, _n in keys["nan"]} == {np.dtype(np.float32)}


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--paged"]])
def test_launcher_ci_chaos_lines(flags, capsys):
    tserve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
                 "--requests", "6", "--max-new", "8", "--chunk-size", "8",
                 "--inject", "nan:step=3", "--inject", "fail:step=7",
                 *flags])
    out = capsys.readouterr().out
    assert "completed=5" in out
    assert "[serve] faults: errors=1 recoveries=1" in out


def test_launcher_exit_contract(capsys):
    with pytest.raises(SystemExit, match="supervise requires --journal"):
        tserve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device",
                     "cpu", "--chunk-size", "8", "--supervise"])
    with pytest.raises(SystemExit, match="RESIDENT"):
        tserve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device",
                     "cpu", "--chunk-size", "8", "--inject", "flip:step=1"])
    # a deadline no request can meet: every request times out, allowed
    tserve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
                 "--chunk-size", "8", "--requests", "3", "--deadline",
                 "1e-9"])
    assert "timeouts=3" in capsys.readouterr().out
