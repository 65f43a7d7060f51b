"""The port's fleet-level fault tolerance on the CPU, at smoke widths (the
tests of ``tests/test_fleet.py`` run against ``repro_torch``): replica
health, failover, integrity scrub, circuit breakers, cancellation, and hot
model add/remove; plus the port's own device rule for the scrub (``flip``
copies the leaf: the engines' tensors are never written) and engine
closing (a dropped or dead replica's core is closed).

The load-bearing claims:

* The HEALTHY -> DEGRADED -> DEAD state machine and the CLOSED -> OPEN ->
  HALF_OPEN breaker behave exactly as documented (unit level, no engines).
* ``flip`` faults are a registry-level kind: the engine-side consumers
  ignore them, the gateway applies them, and the CRC scrub detects and
  repairs them BITWISE from the loaders.
* Killing a replica mid-run loses nothing: every in-flight request fails
  over to a survivor and its final token stream is IDENTICAL to a
  dedicated fault-free engine's — greedy and sampled, window and packed.
* Cancelling a request (the SSE-disconnect path) releases its slot and
  its KV pages immediately, observable via ``EngineStats`` and the pager.
* Hot ADD joins a live stacked group (in-flight work migrates and
  completes); hot REMOVE refuses while pinned and a budget miss rolls the
  registration back.
"""
import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import registry as R
from repro_torch.runtime.faults import FaultPlan, parse_fault
from repro_torch.serving import (FINISH_CANCELLED, LLMEngine, ModelRegistry,
                                 Request, SamplingParams, ServingGateway)
from repro_torch.serving.gateway import (BudgetExceeded, GatewayHTTPServer,
                                         ModelInFlight)
from repro_torch.serving.health import (CLOSED, DEAD, DEGRADED, HALF_OPEN,
                                        HEALTHY, OPEN, CircuitBreaker,
                                        HealthPolicy, ReplicaHealth)
from repro_torch.serving.model_registry import _leaves, make_alpha_variant

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its smoke-sized steps
    gain nothing from more, and beside the rest of the suite on several
    workers every parallel region would wait for threads that the other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_smoke_config("tinyllama_1_1b")
    cfg = cfg.replace(ovsf=dataclasses.replace(cfg.ovsf,
                                               exec_path="spectral"))
    base = R.model_init(cfg, 0, "cpu")
    var = make_alpha_variant(base, seed=1)
    return cfg, base, var


def _flat(params):
    return [t for _p, ts in _leaves(params) for t in ts]


def _req(rid, plen, vocab, max_new=6, model=None, greedy=True):
    rng = np.random.default_rng(100 + rid)
    sp = (SamplingParams() if greedy else
          SamplingParams(temperature=0.8, top_k=20, seed=rid))
    return Request(rid, rng.integers(0, vocab, plen, dtype=np.int32),
                   max_new_tokens=max_new, sampling=sp, model=model)


def _registry(cfg, base, var):
    reg = ModelRegistry()
    reg.register("m-a", cfg, lambda: base)
    reg.register("m-b", cfg, lambda: var)
    return reg


# ---------------------------------------------------------------------------
# Health state machine + circuit breaker (unit level)
# ---------------------------------------------------------------------------

def test_replica_health_state_machine():
    pol = HealthPolicy(degraded_after=1, dead_after=3, forgive_after=2)
    h = ReplicaHealth(pol)
    assert h.state == HEALTHY and h.alive
    assert h.record("quarantine") == DEGRADED
    # two clean steps forgive one point -> back to HEALTHY
    h.ok_step()
    assert h.state == DEGRADED
    assert h.ok_step() == HEALTHY
    # stalls weigh 0 by default (their recovery is what counts)
    assert h.record("stall", 5) == HEALTHY
    assert h.counts["stall"] == 5
    # reaching dead_after is terminal, and sticky against clean steps
    assert h.record("recovery", 3) == DEAD
    assert not h.alive
    for _ in range(10):
        assert h.ok_step() == DEAD
    with pytest.raises(ValueError, match="degraded_after"):
        HealthPolicy(degraded_after=3, dead_after=1)


def test_circuit_breaker_full_cycle():
    t = [0.0]
    br = CircuitBreaker(trip_after=2, cooldown_s=5.0, probes=1,
                        clock=lambda: t[0])
    assert br.allow() and br.state == CLOSED
    br.record_failure()
    assert br.state == CLOSED          # one failure is not a streak
    br.record_failure()
    assert br.state == OPEN and br.trips == 1
    assert not br.allow()
    assert br.retry_after_s() >= 1
    # a success between failures resets the streak
    t[0] += 5.0
    assert br.allow() and br.state == HALF_OPEN   # the one probe
    assert not br.allow()                         # probes exhausted
    br.record_failure()                           # probe failed
    assert br.state == OPEN and br.trips == 2
    t[0] += 5.0
    assert br.allow()
    br.record_success()                           # probe succeeded
    assert br.state == CLOSED and br.allow()
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == CLOSED          # interleaved successes: no trip
    # disabled breaker never refuses
    off = CircuitBreaker(trip_after=0)
    for _ in range(10):
        off.record_failure()
    assert off.allow()


# ---------------------------------------------------------------------------
# flip faults: parsed, engine-inert, registry-applied, scrub-repaired
# ---------------------------------------------------------------------------

def test_flip_fault_parse_and_engine_inertness():
    f = parse_fault("flip:step=3,leaf=2,bit=17")
    assert (f.kind, f.step, f.leaf, f.bit) == ("flip", 3, 2, 17)
    plan = FaultPlan((f,))
    # engine-side consumers must ignore flip: no poison, no raise
    assert plan.poison_row(3, 4) is None
    plan.raise_or_delay(3)
    with pytest.raises(ValueError, match="unknown fault kind"):
        parse_fault("melt:step=1")


def test_registry_scrub_detects_and_repairs_bitwise(tiny):
    cfg, base, var = tiny
    reg = _registry(cfg, base, var)
    g = reg.entries["m-a"].group
    assert reg.ensure_resident_group(g)
    e = reg.entries["m-a"]
    assert e.crc_ledger                    # captured at first load
    assert reg.scrub("m-a") == []          # clean bank scrubs clean
    held = e.params                        # what an engine would hold
    ref = [t.clone() for t in _flat(held)]

    path = reg.corrupt("m-a", leaf=1, bit=9)
    bad = reg.scrub("m-a")
    assert bad == [path]
    assert e.corruptions == 1
    # the flip is a copy in a new tree: the tensors an engine holds (and
    # its graphs read by address) are untouched
    assert e.params is not held
    assert all(torch.equal(a, b) for a, b in zip(ref, _flat(held)))
    # the sibling's bank is untouched
    assert reg.scrub("m-b") == []

    reg.repair("m-a")
    assert e.repairs == 1
    assert reg.scrub("m-a") == []
    again = _flat(reg.entries["m-a"].params)
    for l0, l1 in zip(ref, again):
        assert torch.equal(l0, l1)

    # a loader that no longer reproduces the ledger is checkpoint rot,
    # not a repair — repair must refuse rather than serve changed weights
    flaky = {"params": base}
    reg2 = ModelRegistry()
    reg2.register("rot", cfg, lambda: flaky["params"])
    g2 = reg2.entries["rot"].group
    assert reg2.ensure_resident_group(g2)
    reg2.corrupt("rot")
    flaky["params"] = make_alpha_variant(base, seed=99)
    with pytest.raises(RuntimeError, match="rot"):
        reg2.repair("rot")


def test_registry_unregister_guards(tiny):
    cfg, base, var = tiny
    reg = _registry(cfg, base, var)
    reg.pin("m-a")
    with pytest.raises(RuntimeError, match="in-flight"):
        reg.unregister("m-a")
    reg.unpin("m-a")
    reg.unregister("m-a")
    assert reg.get("m-a") is None
    with pytest.raises(KeyError):
        reg.unregister("m-a")


# ---------------------------------------------------------------------------
# Replicated groups: health-checked failover, token-identical resume
# ---------------------------------------------------------------------------

def _mixed_requests(vocab):
    reqs = []
    for rid in range(6):
        reqs.append(_req(rid, plen=3 + 2 * rid, vocab=vocab,
                         model="m-a" if rid % 2 == 0 else "m-b",
                         greedy=rid < 3))
    return reqs


def _dedicated_streams(cfg, base, var, vocab, **engine_kw):
    outs = {}
    for model, params in [("m-a", base), ("m-b", var)]:
        eng = LLMEngine(params, cfg, batch_slots=4, buffer_len=64,
                        chunk_size=8, device="cpu", use_mapper=False,
                        **engine_kw)
        for r in _mixed_requests(vocab):
            if r.model == model:
                eng.add_request(r)
        eng.run_until_drained()
        for o in eng.outputs():
            outs[o.rid] = tuple(o.tokens)
    return outs


@pytest.mark.parametrize("packed", [False, True], ids=["window", "packed"])
def test_replica_failover_streams_token_identical(tiny, packed):
    cfg, base, var = tiny
    plan = FaultPlan.parse(["fail:step=2"], seed=0)
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=4,
                        buffer_len=64, chunk_size=8, device="cpu", packed=packed,
                        faults={"m-a": plan}, replicas=2,
                        health=HealthPolicy(degraded_after=1, dead_after=1))
    for r in _mixed_requests(cfg.vocab):
        admitted, _ = gw.add_request(r)
        assert admitted
    gw.run_until_drained()
    # the injected kill actually killed a replica and migrated its work
    assert gw.stats.failovers >= 1
    assert gw.stats.replicas_dead >= 1
    assert gw.stats.failover_requests >= 1
    outs = {o.rid: o for o in gw.outputs()}
    assert len(outs) == 6                            # ZERO lost requests
    for o in outs.values():
        assert o.finish_reason in ("eos", "length"), o
    # failover resume is token-identical to fault-free dedicated engines,
    # greedy AND sampled (resume_key stash), for this step style
    want = _dedicated_streams(cfg, base, var, cfg.vocab, packed=packed)
    assert {rid: tuple(o.tokens) for rid, o in outs.items()} == want
    # the group is still serving (survivor or replacement)
    assert gw.engine_for("m-a") is not None
    assert DEAD in gw.health_of("m-a")


def test_single_replica_group_rebuilds_in_place(tiny):
    """Losing the LAST replica must not strand admitted work: a fresh
    replacement (no fault plan) is built in place."""
    cfg, base, var = tiny
    plan = FaultPlan.parse(["fail:step=2"], seed=0)
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=4,
                        buffer_len=64, chunk_size=8, device="cpu",
                        faults={"m-a": plan}, replicas=1,
                        health=HealthPolicy(degraded_after=1, dead_after=1))
    for r in _mixed_requests(cfg.vocab):
        assert gw.add_request(r)[0]
    gw.run_until_drained()
    assert gw.stats.failovers == 1
    assert gw.stats.replicas_built >= 2              # original + replacement
    outs = {o.rid: o for o in gw.outputs()}
    assert len(outs) == 6
    for o in outs.values():
        assert o.finish_reason in ("eos", "length"), o
    assert {rid: tuple(o.tokens) for rid, o in outs.items()} == \
        _dedicated_streams(cfg, base, var, cfg.vocab)


# ---------------------------------------------------------------------------
# Gateway scrub cadence: injected flip detected + repaired mid-traffic
# ---------------------------------------------------------------------------

def test_gateway_scrub_catches_injected_flip(tiny):
    cfg, base, var = tiny
    plan = FaultPlan.parse(["flip:step=1,leaf=3,bit=11"], seed=0)
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=4,
                        buffer_len=64, chunk_size=8, device="cpu",
                        faults={"m-a": plan}, scrub_every=1)
    for r in _mixed_requests(cfg.vocab):
        assert gw.add_request(r)[0]
    gw.run_until_drained()
    s = gw.stats
    assert s.corruptions_injected == 1
    assert s.scrub_corruptions == 1
    assert s.scrub_repairs == 1
    # the repaired bank is bitwise the loader's bank again
    assert gw.registry.scrub("m-a") == []
    # and every request survived the drain/rebuild/resubmit, token-exact
    outs = {o.rid: o for o in gw.outputs()}
    assert len(outs) == 6
    for o in outs.values():
        assert o.finish_reason in ("eos", "length"), o
    assert {rid: tuple(o.tokens) for rid, o in outs.items()} == \
        _dedicated_streams(cfg, base, var, cfg.vocab)


# ---------------------------------------------------------------------------
# Cancellation (the SSE-disconnect path): slot + KV pages released
# ---------------------------------------------------------------------------

def test_cancel_releases_slot_and_kv_pages(tiny):
    # Single-model registry: stacked multi-variant groups refuse paged KV
    # (EngineCore raises NotImplementedError), and this test is about the
    # cancel path reclaiming pages, not cross-model routing.
    cfg, base, _ = tiny
    reg = ModelRegistry()
    reg.register("m-a", cfg, lambda: base)
    gw = ServingGateway(reg, batch_slots=2,
                        buffer_len=64, chunk_size=8, device="cpu",
                        packed=True, paged=True)
    fins = []
    reqs = [_req(rid, 4, cfg.vocab, max_new=24, model="m-a")
            for rid in range(3)]
    for r in reqs:
        r.on_finish = fins.append
        assert gw.add_request(r)[0]
    # run until the victim holds a slot (and so KV pages)
    eng = gw.engine_for("m-a")
    for _ in range(30):
        gw.step()
        if any(sl is reqs[0] for sl in eng.slots):
            break
    assert any(sl is reqs[0] for sl in eng.slots)
    pages_held = eng.core.pager.used_pages
    assert pages_held > 0

    assert gw.cancel(reqs[0])
    assert reqs[0].finish_reason == FINISH_CANCELLED
    assert not any(sl is reqs[0] for sl in eng.slots)     # slot freed NOW
    assert eng.core.pager.used_pages < pages_held         # pages freed NOW
    assert gw.cancel(reqs[0]) is False                    # already finished
    assert eng.stats.cancelled == 1 and gw.stats.cancelled == 1
    assert [o.finish_reason for o in fins
            if o.rid == 0] == [FINISH_CANCELLED]          # exactly once

    # a QUEUED (never-slotted) request cancels too
    r3 = _req(3, 4, cfg.vocab, max_new=24, model="m-a")
    assert gw.add_request(r3)[0]
    assert gw.cancel(r3)
    assert r3.finish_reason == FINISH_CANCELLED

    # survivors run to completion and every page returns to the pool
    gw.run_until_drained()
    assert eng.core.pager.used_pages == 0                 # back to baseline
    outs = {o.rid: o for o in gw.outputs()}
    for rid in (1, 2):
        assert outs[rid].finish_reason in ("eos", "length")
    assert eng.stats.kv_pages_used > 0                    # peak was recorded


# ---------------------------------------------------------------------------
# Hot model ADD / REMOVE on a live pool
# ---------------------------------------------------------------------------

def test_hot_add_joins_live_group_and_migrates_inflight(tiny):
    cfg, base, var = tiny
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=4,
                        buffer_len=64, chunk_size=8, device="cpu")
    live = _req(0, 4, cfg.vocab, max_new=8, model="m-a")
    assert gw.add_request(live)[0]
    for _ in range(3):
        gw.step()                       # the request is mid-generation
    assert not live.done

    third = make_alpha_variant(base, seed=5)
    gw.add_model("m-c", cfg, lambda: third)
    with pytest.raises(ValueError, match="already registered"):
        gw.add_model("m-c", cfg, lambda: third)
    # the group restacked: one engine, three variants, in-flight migrated
    r1 = _req(1, 4, cfg.vocab, model="m-c")
    assert gw.add_request(r1)[0]
    gw.run_until_drained()
    eng = gw.engine_for("m-c")
    assert eng is gw.engine_for("m-a") and eng.variants == 3
    outs = {o.rid: o for o in gw.outputs()}
    assert outs[0].finish_reason in ("eos", "length")     # migrated, done
    assert outs[1].finish_reason in ("eos", "length")
    # the hot model's stream matches a dedicated engine bit-for-bit
    ded = LLMEngine(third, cfg, batch_slots=4, buffer_len=64, chunk_size=8,
                    device="cpu", use_mapper=False)
    ded.add_request(_req(1, 4, cfg.vocab, model="m-c"))
    ded.run_until_drained()
    assert tuple(outs[1].tokens) == tuple(ded.outputs()[0].tokens)


def test_hot_remove_guards_and_budget_rollback(tiny):
    cfg, base, var = tiny
    from repro_torch.configs.base import smoke_variant
    from repro_torch.serving.model_registry import (alpha_bank_bytes,
                                                    param_bytes)
    other_cfg = smoke_variant(cfg, n_layers=1)
    other = R.model_init(other_cfg, 2, "cpu")
    reg = _registry(cfg, base, var)
    gw = ServingGateway(reg, batch_slots=2, buffer_len=64, chunk_size=8,
                        device="cpu")
    live = _req(0, 4, cfg.vocab, max_new=6, model="m-b")
    assert gw.add_request(live)[0]
    with pytest.raises(ModelInFlight, match="in-flight"):
        gw.remove_model("m-b")          # pinned by the live request
    with pytest.raises(KeyError):
        gw.remove_model("ghost")
    gw.run_until_drained()

    # budget miss on hot ADD rolls the registration back entirely
    reg.budget_bytes = param_bytes(base) + alpha_bank_bytes(var)
    with pytest.raises(BudgetExceeded):
        # the resident pair is pinned by nothing, but evicting it cannot
        # help: 'solo' would still exceed the budget together with ZERO
        # other groups only if it alone fits — force the miss by pinning
        reg.pin("m-a")
        try:
            gw.add_model("solo", other_cfg, lambda: other)
        finally:
            reg.unpin("m-a")
    assert reg.get("solo") is None                        # rolled back
    assert gw.engine_for("solo") is None

    # with the budget lifted the same ADD lands, then REMOVE drops it
    reg.budget_bytes = None
    gw.add_model("solo", other_cfg, lambda: other)
    assert gw.add_request(_req(5, 4, other_cfg.vocab, model="solo"))[0]
    gw.run_until_drained()
    gw.remove_model("solo")
    assert reg.get("solo") is None
    with pytest.raises(KeyError):
        gw.add_request(_req(6, 4, other_cfg.vocab, model="solo"))
    # removing a stacked member restacks the survivors
    gw.remove_model("m-b")
    assert gw.add_request(_req(7, 4, cfg.vocab, model="m-a"))[0]
    gw.run_until_drained()
    assert gw.engine_for("m-a").variants == 0             # single again


# ---------------------------------------------------------------------------
# HTTP front door: 400 mapping, Retry-After, breaker, drain, SSE disconnect
# ---------------------------------------------------------------------------

async def _call(host, port, method, path, body=None, raw=None):
    reader, writer = await asyncio.open_connection(host, port)
    payload = raw if raw is not None else (
        b"" if body is None else json.dumps(body).encode())
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Length: {len(payload)}\r\n"
                  "Connection: close\r\n\r\n").encode() + payload)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    rawbody = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except Exception:
        pass
    if "event-stream" in headers.get("content-type", ""):
        return status, [l[6:] for l in rawbody.decode().splitlines()
                        if l.startswith("data: ")], headers
    return status, json.loads(rawbody or b"{}"), headers


def test_http_client_errors_are_400_not_500(tiny):
    cfg, base, var = tiny
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=2,
                        buffer_len=64, chunk_size=8, device="cpu")

    async def drive():
        srv = GatewayHTTPServer(gw, port=0)
        await srv.start()
        try:
            st, body, _ = await _call(srv.host, srv.port, "POST",
                                      "/v1/completions", raw=b"{nope")
            assert st == 400
            assert body["error"]["type"] == "invalid_request_error"
            for bad, param in [({"temperature": "hot"}, "temperature"),
                               ({"max_tokens": 0}, "max_tokens"),
                               ({"top_k": -3}, "top_k"),
                               ({"prompt": {"x": 1}}, "prompt"),
                               ({"prompt": [1, "two"]}, "prompt"),
                               ({"stream": "yes"}, "stream"),
                               ({"deadline_s": 0}, "deadline_s")]:
                req = {"model": "m-a", "prompt": [1]}
                req.update(bad)
                st, body, _ = await _call(srv.host, srv.port, "POST",
                                          "/v1/completions", req)
                assert st == 400, (bad, st, body)
                assert body["error"]["param"] == param
            # a valid request still lands after all those rejections
            st, body, _ = await _call(
                srv.host, srv.port, "POST", "/v1/completions",
                {"model": "m-a", "prompt": [3, 1, 4], "max_tokens": 4})
            assert st == 200
            assert body["choices"][0]["finish_reason"] in ("eos", "length")
        finally:
            await srv.stop()

    asyncio.run(drive())


def test_http_breaker_opens_and_probes_reclose(tiny):
    """Repeated FINISH_ERROR trips the model's breaker to 503+Retry-After;
    after the cooldown a half-open probe re-closes it."""
    cfg, base, var = tiny
    reg = _registry(cfg, base, var)
    # m-a's engine errors exactly once (slot 0 poisoned at core step 0)
    plan = FaultPlan.parse(["nan:step=0,slot=0"], seed=0)
    gw = ServingGateway(reg, batch_slots=2, buffer_len=64, chunk_size=8,
                        device="cpu", faults={"m-a": plan})

    async def drive():
        srv = GatewayHTTPServer(gw, port=0, breaker_after=1,
                                breaker_cooldown_s=0.5)
        await srv.start()
        try:
            body = {"model": "m-a", "prompt": [3, 1, 4], "max_tokens": 4}
            st, resp, _ = await _call(srv.host, srv.port, "POST",
                                      "/v1/completions", body)
            assert st == 200
            assert resp["choices"][0]["finish_reason"] == "error"
            # breaker OPEN: refused up front, with a Retry-After hint
            st, resp, hdrs = await _call(srv.host, srv.port, "POST",
                                         "/v1/completions", body)
            assert st == 503
            assert resp["error"]["code"] == "breaker_open"
            assert int(hdrs["retry-after"]) >= 1
            assert srv.breaker_rejections == 1
            # after the cooldown, the half-open probe succeeds (the nan
            # fault fired once at step 0) and the breaker re-closes
            await asyncio.sleep(0.6)
            st, resp, _ = await _call(srv.host, srv.port, "POST",
                                      "/v1/completions", body)
            assert st == 200
            assert resp["choices"][0]["finish_reason"] in ("eos", "length")
            assert srv._breakers["m-a"].state == CLOSED
        finally:
            await srv.stop()

    asyncio.run(drive())


def test_http_drain_stops_admission_and_finishes_live_work(tiny):
    cfg, base, var = tiny
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=2,
                        buffer_len=64, chunk_size=8, device="cpu")

    async def drive():
        srv = GatewayHTTPServer(gw, port=0)
        await srv.start()
        try:
            live = asyncio.ensure_future(_call(
                srv.host, srv.port, "POST", "/v1/completions",
                {"model": "m-a", "prompt": [3, 1, 4], "max_tokens": 6}))
            await asyncio.sleep(0.05)
            st, body, _ = await _call(srv.host, srv.port, "POST",
                                      "/admin/drain")
            assert st == 200 and body["status"] == "draining"
            st, body, hdrs = await _call(
                srv.host, srv.port, "POST", "/v1/completions",
                {"model": "m-a", "prompt": [1]})
            assert st == 503
            assert body["error"]["code"] == "draining"
            assert "retry-after" in hdrs
            # the in-flight request still finishes, then drained fires
            st, resp, _ = await live
            assert st == 200
            assert resp["choices"][0]["finish_reason"] in ("eos", "length")
            await asyncio.wait_for(srv.drained.wait(), timeout=30)
            assert gw.pending == 0
        finally:
            await srv.stop()

    asyncio.run(drive())


def test_http_sse_disconnect_cancels_and_releases(tiny):
    """An SSE client that goes away mid-stream must CANCEL the request:
    its slot and KV pages return to the pool instead of serving a dead
    socket (asserted via EngineStats + the pager). Single-model registry:
    stacked multi-variant groups refuse paged KV, and the page-reclaim
    assertion is the point here."""
    cfg, base, _ = tiny
    reg = ModelRegistry()
    reg.register("m-a", cfg, lambda: base)
    gw = ServingGateway(reg, batch_slots=2,
                        buffer_len=128, chunk_size=8, device="cpu",
                        packed=True, paged=True)

    async def drive():
        srv = GatewayHTTPServer(gw, port=0)
        await srv.start()
        try:
            reader, writer = await asyncio.open_connection(srv.host,
                                                           srv.port)
            payload = json.dumps(
                {"model": "m-a", "prompt": [3, 1, 4],
                 "max_tokens": 100, "stream": True}).encode()
            writer.write((f"POST /v1/completions HTTP/1.1\r\n"
                          f"Host: {srv.host}\r\n"
                          f"Content-Length: {len(payload)}\r\n"
                          "Connection: close\r\n\r\n").encode() + payload)
            await writer.drain()
            await reader.readline()              # status line
            # wait for the first streamed token, then vanish
            while True:
                line = await reader.readline()
                if line.startswith(b"data: "):
                    break
            writer.transport.abort()             # hard client disconnect
            # the server notices on its next token write and cancels
            for _ in range(400):
                if gw.stats.cancelled:
                    break
                await asyncio.sleep(0.025)
            assert gw.stats.cancelled == 1
            eng = gw.engine_for("m-a")
            assert eng.stats.cancelled == 1
            assert eng.core.pager.used_pages == 0     # pages back to pool
            assert all(sl is None for sl in eng.slots)
            assert gw.pending == 0
            # the pool still serves normally afterwards
            st, resp, _ = await _call(
                srv.host, srv.port, "POST", "/v1/completions",
                {"model": "m-a", "prompt": [2, 7], "max_tokens": 4})
            assert st == 200
            assert resp["choices"][0]["finish_reason"] in ("eos", "length")
        finally:
            await srv.stop()

    asyncio.run(drive())


# ---------------------------------------------------------------------------
# The port's device rule: engines that leave the pool are closed
# ---------------------------------------------------------------------------

def test_dropped_and_dead_replicas_are_closed(tiny):
    """A scrub repair drops the group's engines and a dead replica leaves
    the pool: each one's core is closed (caches, graphs and graph pools
    freed; on the card a graph holds raw addresses of the params and
    caches), and the rebuilt engines serve the repaired params."""
    cfg, base, var = tiny
    plan = FaultPlan.parse(["fail:step=1", "flip:step=2,leaf=0,bit=3"],
                           seed=0)
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=4,
                        buffer_len=64, chunk_size=8, device="cpu",
                        faults={"m-a": plan}, replicas=2, scrub_every=3,
                        health=HealthPolicy(degraded_after=1, dead_after=1))
    for r in _mixed_requests(cfg.vocab):
        assert gw.add_request(r)[0]
    first = list(gw._groups[gw.registry.entries["m-a"].group].engines)
    gw.run_until_drained()
    assert gw.stats.failovers >= 1 and gw.stats.scrub_repairs == 1
    assert all(e.core.caches is None for e in first)
    live = gw.engine_for("m-a")
    assert live not in first and live.core.caches is not None
    assert {o.rid: tuple(o.tokens) for o in gw.outputs()} == \
        _dedicated_streams(cfg, base, var, cfg.vocab)
