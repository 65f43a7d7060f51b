"""The port's legacy phase-based serving path (``LLMEngine(chunk_size=None)``:
bucketed prefill groups, exact prefill, the all-slot decode) vs the JAX
package, on the smoke TinyLlama config in fp32 on the CPU, with the same
params (``bridge.params_from_numpy``) and the same seeded requests:

* ``bucket_lengths``, ``bucket_for``, ``next_group`` (order and groups) and
  the legacy ``schedule`` equal the reference's, including a hypothesis
  trace over arrival mixes, bucketed and not;
* ``serve_prefill`` and ``serve_prefill_ragged``: logits and caches within
  1e-4; after every engine step, every slot's K/V rows (those a prefill
  group adopted among them) within 1e-4 and its ``pos`` equal to the
  reference engine's;
* greedy streams, finish reasons and counters equal the JAX legacy
  engine's at one slot, all-decode, with mid-run admissions (the
  reference's garbage token of a slot prefilled in a step that also
  decodes, copied for parity), bucketed and ``bucketed_prefill=False``,
  under ``nan`` and ``fail`` injections, with deadlines, shedding and
  ``cancel()``, and through a three-method legacy scheduler;
  ``prefill_compiles`` equals the reference's; after a crash the journal
  recovers a legacy engine's streams token for token;
* the reference's anchors on the port: ``test_packed_matches_unchunked_
  single_slot`` and ``test_all_decode_tri_path_identical`` (sampled slots
  within the port only);
* the bucketed prefill body issues no host-reading op (the check of
  ``test_torch_graphs.py``); exact prefills run eagerly, outside any
  graph;
* a prefill writes a cache as deep as its call (the bucket, or the
  prompt), not the buffer's depth, and the slot it is adopted into holds
  zeros past it.
"""
import dataclasses
import functools

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
from repro.serving import scheduler as jsched
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import bridge
from repro_torch.models import attention as tattn
from repro_torch.models import registry as tR
from repro_torch.runtime import faults as tfaults
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSampling
from repro_torch.serving import scheduler as tsched
from test_torch_graphs import _FUSED, _HostReads, _recording, _stub_kernels

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its smoke-sized steps
    gain nothing from more, and beside the rest of the suite on several
    workers every parallel region waits for threads other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fused(cfg):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, exec_path="fused"))


@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg = _fused(j_smoke("tinyllama_1_1b"))
    tcfg = _fused(t_smoke("tinyllama_1_1b"))
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


# -- the scheduler ------------------------------------------------------------

@pytest.mark.parametrize("buffer_len,min_bucket,n_buckets",
                         [(64, 8, 0), (256, 8, 0), (100, 4, 0), (8, 8, 0),
                          (5, 8, 0), (512, 16, 3), (1, 1, 0)])
def test_buckets_match_reference(buffer_len, min_bucket, n_buckets):
    got = tsched.bucket_lengths(buffer_len, min_bucket=min_bucket,
                                n_buckets=n_buckets)
    assert got == jsched.bucket_lengths(buffer_len, min_bucket=min_bucket,
                                        n_buckets=n_buckets)
    for plen in range(1, got[-1] + 1):
        assert tsched.bucket_for(plen, got) == jsched.bucket_for(plen, got)
    for mod in (tsched, jsched):
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            mod.bucket_for(got[-1] + 1, got)


def _sched_pair(bucketing, **kw):
    return (jsched.FCFSScheduler(64, bucketing=bucketing, **kw),
            tsched.FCFSScheduler(64, bucketing=bucketing, **kw))


def _group(g):
    return None if g is None else (g.bucket, [r.rid for r in g.requests])


_OPS = st.lists(st.one_of(
    st.tuples(st.just("add"), st.integers(1, 70), st.integers(0, 2)),
    st.tuples(st.just("group"), st.integers(0, 5), st.just(0))),
    min_size=1, max_size=40)


@settings(max_examples=40, deadline=None)
@given(ops=_OPS, bucketing=st.booleans())
def test_next_group_trace_matches_reference(ops, bucketing):
    """Arrivals of random lengths and priorities, groups of random sizes
    popped between them: the same groups, in the same order, and the same
    queue, as the reference's scheduler."""
    js, ts = _sched_pair(bucketing)
    for rid, (op, a, prio) in enumerate(ops):
        if op == "add":
            prompt = np.arange(a, dtype=np.int32) + 1
            got = ts.add(TRequest(rid, prompt, max_new_tokens=4,
                                  priority=prio))
            want = js.add(JRequest(rid, prompt, max_new_tokens=4,
                                   priority=prio))
            assert got == want
        else:
            assert _group(ts.next_group(a)) == _group(js.next_group(a))
        assert [r.rid for r in ts.waiting] == [r.rid for r in js.waiting]
        assert len(ts) == len(js)


def _legacy_view(so):
    return (so.decode_slots, [(pg.bucket, pg.exact,
                               [(s, r.rid) for s, r in pg.slot_reqs])
                              for pg in so.prefill_groups],
            so.chunks, so.n_scheduled_tokens)


@pytest.mark.parametrize("exact", [False, True])
def test_legacy_schedule_matches_reference(exact):
    js, ts = _sched_pair(not exact)
    for rid, plen in enumerate([3, 30, 5, 9, 12, 40, 7]):
        prompt = np.ones(plen, np.int32)
        js.add(JRequest(rid, prompt, max_new_tokens=4))
        ts.add(TRequest(rid, prompt, max_new_tokens=4))
    running_j = [(0, JRequest(90, np.ones(4, np.int32)), 4)]
    running_t = [(0, TRequest(90, np.ones(4, np.int32)), 4)]
    for free in ([1, 2, 3], [2], [1, 3]):
        want = js.schedule(running_j, free, exact_prefill=exact)
        got = ts.schedule(running_t, free, exact_prefill=exact)
        assert _legacy_view(got) == _legacy_view(want)
        assert got.prefill_groups and got.empty is False


def test_legacy_scheduler_refuses_preempt():
    for mod in (jsched, tsched):
        with pytest.raises(ValueError, match="requires chunk_size"):
            mod.FCFSScheduler(64, admission="preempt")


# -- the prefill entry points -------------------------------------------------

def test_prefill_matches_reference():
    jcfg, tcfg, jparams, tparams = _smoke()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (3, 11)).astype(np.int32)
    jl, jc = jR.serve_prefill(jparams, jcfg, {"tokens": tokens}, 32)
    tl, tc = tR.serve_prefill(tparams, tcfg, torch.from_numpy(tokens), 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert tc["pos"].tolist() == [11] * 3 and int(jc["pos"]) == 11
    lengths = np.array([11, 1, 6], np.int32)
    jl, jc = jR.serve_prefill_ragged(jparams, jcfg, {"tokens": tokens}, 32,
                                     lengths)
    tl, tc = tR.serve_prefill_ragged(tparams, tcfg, torch.from_numpy(tokens),
                                     32, torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-4, atol=1e-4)
    # causal: a row's logits at its length ignore its padding
    alone, _ = tR.serve_prefill(tparams, tcfg,
                                torch.from_numpy(tokens[2:, :6]), 32)
    np.testing.assert_allclose(tl[2:].numpy(), alone.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_prefill_past_sdpa_rows_matches_reference():
    """A bucket longer than ``attention.SDPA_ROWS`` (its attention split
    into query blocks, the last one partial): logits and caches as the
    reference's single ``sdpa``."""
    jcfg, tcfg, jparams, tparams = _smoke()
    S = 2 * tattn.SDPA_ROWS + 22
    tokens = np.random.default_rng(2).integers(0, 512, (2, S)).astype(
        np.int32)
    lengths = np.array([S, S - 70], np.int32)
    jl, jc = jR.serve_prefill_ragged(jparams, jcfg, {"tokens": tokens}, S,
                                     lengths)
    tl, tc = tR.serve_prefill_ragged(tparams, tcfg, torch.from_numpy(tokens),
                                     S, torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-4, atol=1e-4)


# -- the legacy engine vs the JAX legacy engine -------------------------------

def _specs(lens, max_new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(1, 500, plen, dtype=np.int32), max_new)
            for rid, plen in enumerate(lens)]


def _engines(specs, faults=None, **kw):
    """The same requests through the JAX and the port's legacy engines,
    stepped in lockstep: per-slot ``pos`` compared after every step."""
    jcfg, tcfg, jparams, tparams = _smoke()
    kw = {"batch_slots": 4, "buffer_len": 64, **kw}
    jeng = JEngine(jparams, jcfg, use_mapper=False,
                   faults=jfaults.FaultPlan.parse(faults) if faults else None,
                   **kw)
    teng = TEngine(tparams, tcfg, device="cpu",
                   faults=tfaults.FaultPlan.parse(faults) if faults else None,
                   **kw)
    for eng, make in ((jeng, JRequest), (teng, TRequest)):
        for rid, prompt, max_new in specs:
            eng.submit(make(rid, prompt, max_new_tokens=max_new))
    pos = []
    for _ in range(200):
        left = jeng.step()
        assert teng.step() == left
        if not jeng.stats.recoveries:
            want = np.asarray(jeng.core.caches["pos"])
            assert teng.core.caches["pos"].tolist() == want.tolist()
            pos.append(want.tolist())
            # the reference's (B, nl, 1, T, ...) slot caches vs (nl, B, T, ...)
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    teng.core.caches[name].numpy(),
                    np.asarray(jeng.core.caches[name])[:, :, 0]
                    .transpose(1, 0, 2, 3, 4), rtol=1e-4, atol=1e-4)
        if not left:
            break
    return jeng, teng, pos


def _outs(eng):
    return {o.rid: (o.finish_reason, list(o.tokens)) for o in eng.outputs()}


_COUNTERS = ("steps", "tokens_out", "prefills", "prefill_batches",
             "prefill_compiles", "step_compiles", "packed_tokens",
             "padded_tokens", "completed", "errors", "recoveries")


def _same(jeng, teng, n):
    got, want = _outs(teng), _outs(jeng)
    assert len(want) == n and got == want
    assert {k: getattr(teng.stats, k) for k in _COUNTERS} == \
        {k: getattr(jeng.stats, k) for k in _COUNTERS}
    return got


@pytest.mark.parametrize("case,lens,kw", [
    ("one slot", [5, 17, 24], dict(batch_slots=1)),
    ("all decode", [6, 9, 14, 3], dict()),
    ("mid-run admissions", [3, 30, 5, 9, 12, 40, 7, 20], dict()),
    ("mid-run, unbucketed", [3, 30, 5, 9, 12, 40, 7, 20],
     dict(bucketed_prefill=False)),
])
def test_legacy_engine_matches_reference(case, lens, kw):
    jeng, teng, pos = _engines(_specs(lens), **kw)
    _same(jeng, teng, len(lens))
    assert teng.core.step_shapes == jeng.core.step_shapes == {("decode", 1)}
    assert teng.core.T_alloc == jeng.core.T_alloc == 64
    if case.startswith("mid-run"):
        # the copied defect: a slot prefilled in a step that also decodes
        # is advanced by that decode, one past its prompt
        assert any(p[i] == lens[4] + 1 for p in pos for i in range(4))


def test_prefill_compiles_match_reference():
    """The reference's ``test_bucketed_prefill_traces_at_most_n_buckets``
    (4 buckets of 8 distinct lengths) and ``test_unbucketed_prefill_traces_
    per_distinct_length``, on both engines."""
    lens = [3, 5, 9, 13, 17, 25, 33, 47]
    jeng, teng, _pos = _engines(_specs(lens, max_new=2))
    _same(jeng, teng, len(lens))
    assert teng.stats.prefill_compiles == 4
    assert teng.stats.prefill_s > 0 and teng.stats.decode_s > 0
    jeng, teng, _pos = _engines(_specs(lens[:4], max_new=2),
                                bucketed_prefill=False)
    _same(jeng, teng, 4)
    assert teng.stats.prefill_compiles == 4
    assert sorted(teng.core._prefill_keys) == [
        ("prefill_exact", n) for n in lens[:4]]


@pytest.mark.parametrize("faults", [["nan:step=3", "fail:step=7"],
                                    ["nan:step=0", "nan:step=4,slot=2"]])
def test_legacy_engine_under_faults_matches_reference(faults):
    jeng, teng, _pos = _engines(_specs([3, 30, 5, 9, 12, 40, 7, 20]),
                                faults=faults)
    got = _same(jeng, teng, 8)
    assert teng.stats.errors == sum(r == "error" for r, _t in got.values())


def test_three_method_scheduler_is_adapted():
    """A scheduler with only ``add`` / ``next_group`` / ``__len__`` runs
    through ``legacy_schedule``, with the default scheduler's streams."""
    _jcfg, tcfg, _jp, tparams = _smoke()

    class Legacy:
        def __init__(self):
            self._s = tsched.FCFSScheduler(64)

        def add(self, req):
            return self._s.add(req)

        def next_group(self, n):
            return self._s.next_group(n)

        def __len__(self):
            return len(self._s)

    specs = _specs([3, 30, 5, 9, 12, 40])
    outs = []
    for sched in (None, Legacy()):
        eng = TEngine(tparams, tcfg, batch_slots=4, buffer_len=64,
                      scheduler=sched, device="cpu")
        for rid, prompt, max_new in specs:
            eng.submit(TRequest(rid, prompt, max_new_tokens=max_new))
        eng.run_until_drained()
        outs.append(_outs(eng))
    assert len(outs[0]) == 6 and outs[0] == outs[1]
    with pytest.raises(ValueError, match="requires a step scheduler"):
        TEngine(tparams, tcfg, chunk_size=8, packed=True, scheduler=Legacy(),
                device="cpu")


@pytest.mark.parametrize("case", ["deadline", "max_waiting", "cancel"])
def test_legacy_lifetimes_match_reference(case):
    """Deadlines, a bounded queue's shedding and ``cancel()`` in legacy
    mode: finish reasons, streams and counters equal the reference's."""
    jcfg, tcfg, jparams, tparams = _smoke()
    kw = dict(batch_slots=2, buffer_len=64,
              max_waiting=2 if case == "max_waiting" else None)
    jeng = JEngine(jparams, jcfg, use_mapper=False, **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    for eng, make in ((jeng, JRequest), (teng, TRequest)):
        reqs = [make(rid, prompt, max_new_tokens=max_new,
                     deadline_s=1e-6 if case == "deadline" and rid == 0
                     else None)
                for rid, prompt, max_new in _specs([3, 30, 5, 9])]
        for r in reqs:
            eng.submit(r)
        if case == "cancel":
            eng.step()
            assert eng.cancel(reqs[1]) and eng.cancel(reqs[3])
            assert not eng.cancel(reqs[3])
        eng.run_until_drained()
    got = _same(jeng, teng, 4)
    counter = {"deadline": "timeouts", "max_waiting": "shed",
               "cancel": "cancelled"}[case]
    assert getattr(teng.stats, counter) == getattr(jeng.stats, counter) > 0
    assert sum(r in ("length", "eos") for r, _t in got.values()) < 4


def test_legacy_crash_recovery_token_identical(tmp_path):
    """The write-ahead journal in legacy mode: a process that dies after a
    few steps recovers every live request through the recompute path (its
    prompt plus the tokens it emitted, prefilled whole) and finishes with
    the streams of a run without the crash, greedy and sampled."""
    from repro_torch.serving import RequestJournal
    _jcfg, tcfg, _jp, tparams = _smoke()
    specs = _specs([5, 9, 7, 6], max_new=8)

    def engine(journal=None):
        return TEngine(tparams, tcfg, batch_slots=4, buffer_len=64,
                       journal=journal, device="cpu")

    def submit(eng):
        for rid, prompt, max_new in specs:
            eng.submit(TRequest(rid, prompt, max_new_tokens=max_new,
                                sampling=TSampling(temperature=0.9, seed=rid)
                                if rid % 2 else TSampling()))

    ref = engine()
    submit(ref)
    ref.run_until_drained()
    want = _outs(ref)
    journal = RequestJournal(str(tmp_path / "j"))
    eng = engine(journal)
    submit(eng)
    for _ in range(3):                  # die mid-stream
        eng.step()
    journal.close()
    journal = RequestJournal(str(tmp_path / "j"))
    eng = engine(journal)
    assert len(eng.recover_from_journal()) == 4
    eng.run_until_drained()
    assert _outs(eng) == want and len(want) == 4


# -- the reference's anchors on the port --------------------------------------

def _port_run(specs, sampled=(), **kw):
    _jcfg, tcfg, _jp, tparams = _smoke()
    eng = TEngine(tparams, tcfg, device="cpu", **kw)
    for rid, prompt, max_new in specs:
        r = TRequest(rid, prompt, max_new_tokens=max_new)
        if rid in sampled:
            r.sampling = TSampling(temperature=0.8 + 0.5 * rid, top_k=12,
                                   seed=7 + rid)
        eng.submit(r)
    eng.run_until_drained()
    return _outs(eng), eng


@pytest.mark.parametrize("plen", [5, 17, 24])
def test_packed_matches_unchunked_single_slot(plen):
    """The reference's anchor at B = 1, where no slot is reused: the
    legacy stream equals the packed one."""
    specs = [(2, np.random.default_rng(2).integers(0, 512, plen,
                                                   dtype=np.int32), 4)]
    ref, _e = _port_run(specs, batch_slots=1, buffer_len=64)
    got, _e = _port_run(specs, batch_slots=1, buffer_len=64, chunk_size=8,
                        packed=True)
    assert got == ref and len(got[2][1]) == 4


def test_all_decode_tri_path_identical():
    """The reference's anchor: every slot fills in the first step, so every
    later step is chunk-free; legacy, the W = 1 window and the packed step
    give the same streams, greedy and sampled slots mixed."""
    specs = _specs([6, 6, 6], max_new=6)
    kw = dict(batch_slots=3, buffer_len=32)
    legacy, _e = _port_run(specs, sampled=(1, 2), **kw)
    windowed, eng_w = _port_run(specs, sampled=(1, 2), chunk_size=1, **kw)
    packed, eng_p = _port_run(specs, sampled=(1, 2), chunk_size=1,
                              packed=True, **kw)
    assert packed == windowed == legacy
    assert ("window", 1) in eng_w.core.step_shapes
    assert any(k == "packed" for k, _t in eng_p.core.step_shapes)


# -- graph safety -------------------------------------------------------------

@pytest.mark.parametrize("bucketed", [True, False])
def test_prefill_body_reads_nothing_back(bucketed, monkeypatch):
    _stub_kernels(monkeypatch)
    _jcfg, tcfg, _jp, tparams = _smoke()
    eng = TEngine(tparams, tcfg.replace(exec_plan=_FUSED), batch_slots=4,
                  buffer_len=64, bucketed_prefill=bucketed, device="cpu")
    mode = _HostReads()
    run, keys = _recording(eng.core.graphs, mode), []
    eng.core.graphs.run = lambda key, *a, **kw: keys.append(
        (key, kw.get("pool"))) or run(key, *a, **kw)
    for rid, prompt, max_new in _specs([3, 30, 5, 9, 12]):
        eng.submit(TRequest(rid, prompt, max_new_tokens=2,
                            sampling=TSampling(temperature=0.7, seed=rid)))
    eng.run_until_drained()
    assert eng.stats.completed == 5 and eng.stats.prefill_compiles >= 2
    assert not mode.bad, sorted(set(mode.bad))
    assert "index_put_" in mode.ops or "index_put" in mode.ops
    # bucketed prefills are captured, into the one pool they share; exact
    # ones run eagerly (a graph per prompt length would grow with the
    # traffic), so none reaches a graph
    prefill = {(k[0], pool) for k, pool in keys if k[0].startswith("prefill")}
    assert (prefill == {("prefill", "prefill")} if bucketed
            else not prefill), sorted(set(keys))


@pytest.mark.parametrize("bucketed", [True, False])
def test_prefill_cache_is_as_deep_as_its_prompts(bucketed):
    """A prefill writes a cache only as deep as its call (Lb, or the prompt
    at native length), not the buffer's depth: a captured bucket keeps its
    cache in its graph's pool for the life of the core. The slot it is
    adopted into holds zeros past that depth."""
    _jcfg, tcfg, _jp, tparams = _smoke()
    eng = TEngine(tparams, tcfg, batch_slots=4, buffer_len=64,
                  bucketed_prefill=bucketed, device="cpu")
    core, depths = eng.core, []
    for name in ("_prefill_body", "_prefill_exact_body"):
        body = getattr(core, name)

        def recorded(a, body=body):
            out = body(a)
            depths.append((a["tokens"].shape[1], out[2].shape[2],
                           out[3].shape[2]))
            return out
        setattr(core, name, recorded)
    core.caches["k"].fill_(1.0)
    core.caches["v"].fill_(1.0)
    for rid, prompt, max_new in _specs([3, 30, 5, 9]):
        eng.submit(TRequest(rid, prompt, max_new_tokens=3))
    eng.step()              # the prefills, then the all-slot decode
    assert len(depths) == (3 if bucketed else 4)    # buckets 8, 16, 32
    assert all(s == dk == dv for s, dk, dv in depths), depths
    assert max(s for s, _k, _v in depths) < core.T_alloc
    for i, req in enumerate(eng.slots):     # the decode wrote at pos
        past = min(s for s, _k, _v in depths if s >= req.prompt_len)
        for name in ("k", "v"):
            assert not core.caches[name][:, i, past + 1:].any()
