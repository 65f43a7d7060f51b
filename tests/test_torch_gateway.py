"""The port's multi-model gateway (``repro_torch.serving.gateway`` and
``model_registry``, ``repro_torch.launch.gateway``) on the CPU, at smoke
widths: the tests of ``tests/test_gateway.py`` run against the port, the
HTTP idempotency tests of ``tests/test_durability.py``, the four CI gateway
lines through the port's launcher with ``--device cpu``, and the thread
rule of the HTTP server (no handler touches the device: every gateway call
runs on the pump thread).

The load-bearing claims, as the reference's:

* ``stack_variants`` stacks only the alpha leaves (a leading variant axis
  on each per-layer tensor) and rejects trees that do not stack.
* A gateway request's stream is IDENTICAL to a dedicated single-model
  ``LLMEngine`` run of the same request (greedy and sampled, window and
  packed); dedicated baselines pin the spectral path (``use_mapper=False``
  and ``exec_path="spectral"``), which the multi path equals bit for bit.
* Evict-then-reload through a saved checkpoint restores bitwise alpha
  banks, and an unloadable model answers ``FINISH_EVICTED`` (then admits
  again once the budget allows).
* A fault plan scoped to one model's engine cannot poison another engine.
"""
import asyncio
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import smoke_variant
from repro_torch.launch import gateway as tlaunch
from repro_torch.models import registry as R
from repro_torch.runtime.faults import FaultPlan
from repro_torch.serving import (FINISH_EVICTED, LLMEngine, ModelRegistry,
                                 Request, RequestJournal, SamplingParams,
                                 ServingGateway)
from repro_torch.serving.gateway import GatewayHTTPServer
from repro_torch.serving.model_registry import (_leaves, alpha_bank_bytes,
                                                arch_signature,
                                                dense_fp32_bytes,
                                                make_alpha_variant,
                                                param_bytes, stack_variants)

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
    """Spectral-pinned smoke config + base/variant params."""
    cfg = get_smoke_config("tinyllama_1_1b")
    cfg = cfg.replace(ovsf=dataclasses.replace(cfg.ovsf,
                                               exec_path="spectral"))
    base = R.model_init(cfg, 0, "cpu")
    var = make_alpha_variant(base, seed=1)
    return cfg, base, var


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


def _flat(params):
    return [t for _p, ts in _leaves(params) for t in ts]


# ---------------------------------------------------------------------------
# Registry: bytes, stacking, LRU, pinning, budget rollback
# ---------------------------------------------------------------------------

def test_byte_accounting_orders_sanely(tiny):
    cfg, base, _ = tiny
    total = param_bytes(base)
    bank = alpha_bank_bytes(base)
    assert 0 < bank < total
    assert dense_fp32_bytes(cfg) > 0
    assert bank < dense_fp32_bytes(cfg)
    assert total == sum(t.numel() * t.element_size()
                        for t in R.leaves(base))


def test_stack_variants_axis_and_validation(tiny):
    cfg, base, var = tiny
    vset = stack_variants([("a", base), ("b", var)], cfg)
    assert vset.M == 2 and vset.index("b") == 1 and vset.index(None) == 0
    saw_alpha = False
    for (path, ts), (_p, bts) in zip(_leaves(vset.params), _leaves(base)):
        for leaf, b in zip(ts, bts):
            if path[-1] in ("alphas", "alphas_q8", "alphas_q4",
                            "alpha_scale"):
                saw_alpha = True
                # each per-layer tensor leads with the variant axis
                assert leaf.shape[0] == 2, path
                assert torch.equal(leaf[0], b), path
            else:
                assert leaf.shape == b.shape, path
    assert saw_alpha
    with pytest.raises(ValueError, match=">= 2"):
        stack_variants([("a", base)], cfg)
    bad = {**base, "embed": {"table": base["embed"]["table"] + 1.0}}
    with pytest.raises(ValueError, match="shared leaf"):
        stack_variants([("a", base), ("bad", bad)], cfg)


def test_make_alpha_variant_touches_only_alphas(tiny):
    _, base, var = tiny
    for (path, ts), (_p, vts) in zip(_leaves(base), _leaves(var)):
        for a, b in zip(ts, vts):
            same = torch.equal(a, b)
            if path[-1] in ("alphas", "alpha_scale"):
                assert not same, path
            else:
                assert same, path


def test_registry_lru_eviction_pinning_and_rollback(tiny):
    cfg, base, var = tiny
    other_cfg = smoke_variant(cfg, n_layers=1)
    other = R.model_init(other_cfg, 2, "cpu")
    assert arch_signature(other_cfg) != arch_signature(cfg)

    reg = ModelRegistry()
    reg.register("m-a", cfg, lambda: base)
    reg.register("m-b", cfg, lambda: var)
    reg.register("solo", other_cfg, lambda: other)
    ga = reg.entries["m-a"].group
    gs = reg.entries["solo"].group
    assert reg.entries["m-b"].group == ga

    assert reg.ensure_resident_group(ga) and reg.ensure_resident_group(gs)
    pair_bytes = param_bytes(base) + alpha_bank_bytes(var)
    assert reg.resident_bytes() == pair_bytes + param_bytes(other)

    dropped = []
    reg.budget_bytes = pair_bytes
    reg.touch("solo")
    reg.touch("m-a")
    reg.evict_group(ga)
    assert reg.ensure_resident_group(ga, on_evict=dropped.append)
    assert dropped == [gs]
    assert not reg.entries["solo"].resident
    assert reg.entries["solo"].evictions == 1

    reg.pin("m-b")
    assert not reg.ensure_resident_group(gs, on_evict=dropped.append)
    assert not reg.entries["solo"].resident
    assert reg.entries["m-a"].resident
    reg.unpin("m-b")
    assert reg.ensure_resident_group(gs)
    assert not reg.entries["m-a"].resident


# ---------------------------------------------------------------------------
# Token-exact equivalence: gateway == dedicated engines
# ---------------------------------------------------------------------------

def _mk_requests(vocab):
    return [_req(rid, plen=3 + 2 * rid, vocab=vocab,
                 model="m-a" if rid % 2 == 0 else "m-b", greedy=rid < 3)
            for rid in range(6)]


def _dedicated_streams(cfg, base, var, vocab, **engine_kw):
    outs = {}
    for model, params in [("m-a", base), ("m-b", var)]:
        eng = LLMEngine(params, cfg, batch_slots=4, buffer_len=64,
                        chunk_size=8, device="cpu", use_mapper=False,
                        **engine_kw)
        for r in _mk_requests(vocab):
            if r.model == model:
                eng.add_request(r)
        eng.run_until_drained()
        for o in eng.outputs():
            outs[o.rid] = tuple(o.tokens)
    return outs


@pytest.mark.parametrize("packed", [False, True], ids=["window", "packed"])
def test_gateway_tokens_match_dedicated_engines(tiny, packed):
    cfg, base, var = tiny
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=4,
                        buffer_len=64, chunk_size=8, device="cpu",
                        packed=packed)
    for r in _mk_requests(cfg.vocab):
        admitted, _ = gw.add_request(r)
        assert admitted
    gw.run_until_drained()
    got = {o.rid: tuple(o.tokens) for o in gw.outputs()}
    want = _dedicated_streams(cfg, base, var, cfg.vocab, packed=packed)
    assert got == want
    eng = gw.engine_for("m-a")
    assert eng is gw.engine_for("m-b")
    assert eng.variants == 2
    assert len(eng.core.step_shapes) <= 2


# ---------------------------------------------------------------------------
# Eviction: FINISH_EVICTED backpressure + bitwise reload
# ---------------------------------------------------------------------------

def test_finish_evicted_backpressure_then_requeue(tiny):
    cfg, base, var = tiny
    other_cfg = smoke_variant(cfg, n_layers=1)
    other = R.model_init(other_cfg, 2, "cpu")
    reg = ModelRegistry()
    reg.register("m-a", cfg, lambda: base)
    reg.register("m-b", cfg, lambda: var)
    reg.register("solo", other_cfg, lambda: other)
    gw = ServingGateway(reg, batch_slots=2, buffer_len=64, chunk_size=8,
                        device="cpu")
    reg.budget_bytes = param_bytes(base) + alpha_bank_bytes(var)

    fins = []
    r0 = _req(0, 4, cfg.vocab, model="m-a")
    r0.on_finish = fins.append
    admitted, _ = gw.add_request(r0)
    assert admitted

    r1 = _req(1, 4, other_cfg.vocab, model="solo")
    r1.on_finish = fins.append
    admitted, info = gw.add_request(r1)
    assert (admitted, info) == (False, FINISH_EVICTED)
    assert [o.finish_reason for o in fins if o.rid == 1] == [FINISH_EVICTED]
    assert gw.stats.evicted_refusals == 1
    assert not reg.entries["solo"].resident
    assert gw.engine_for("solo") is None

    gw.run_until_drained()
    assert [o.finish_reason for o in fins if o.rid == 0] != [FINISH_EVICTED]
    reg.budget_bytes = None
    admitted, _ = gw.add_request(_req(2, 4, other_cfg.vocab, model="solo"))
    assert admitted
    gw.run_until_drained()
    assert gw.stats.reloads == 1
    assert reg.entries["solo"].resident


def test_evict_then_reload_restores_bitwise_alpha_banks(tiny, tmp_path):
    cfg, base, var = tiny
    torch.save(base, tmp_path / "a.pt")
    torch.save(var, tmp_path / "b.pt")
    reg = ModelRegistry()
    reg.register("m-a", cfg, lambda: torch.load(tmp_path / "a.pt"))
    reg.register("m-b", cfg, lambda: torch.load(tmp_path / "b.pt"))
    g = reg.entries["m-a"].group
    assert reg.ensure_resident_group(g)
    first = {n: _flat(reg.entries[n].params) for n in ("m-a", "m-b")}
    reg.evict_group(g)
    assert all(not reg.entries[n].resident for n in ("m-a", "m-b"))
    assert reg.ensure_resident_group(g)
    assert reg.entries["m-a"].loads == 2
    for n, ref in (("m-a", base), ("m-b", var)):
        again = _flat(reg.entries[n].params)
        for l0, l1, lr in zip(first[n], again, _flat(ref)):
            assert torch.equal(l0, l1) and torch.equal(l1, lr)
        assert reg.scrub(n) == []


# ---------------------------------------------------------------------------
# Fault isolation: per-model NaN quarantine
# ---------------------------------------------------------------------------

def test_nan_quarantine_stays_on_injected_engine(tiny):
    cfg, base, var = tiny
    other_cfg = smoke_variant(cfg, n_layers=1)
    other = R.model_init(other_cfg, 2, "cpu")
    reg = ModelRegistry()
    reg.register("clean", cfg, lambda: base)
    reg.register("chaos", other_cfg, lambda: other)
    plan = FaultPlan.parse(["nan:step=0,slot=0"], seed=0)
    gw = ServingGateway(reg, batch_slots=2, buffer_len=64, chunk_size=8,
                        device="cpu", faults={"chaos": plan})
    for rid, model in [(0, "clean"), (1, "chaos"), (2, "clean")]:
        vocab = cfg.vocab if model == "clean" else other_cfg.vocab
        admitted, _ = gw.add_request(_req(rid, 4, vocab, model=model))
        assert admitted
    gw.run_until_drained()
    outs = {o.rid: o for o in gw.outputs()}
    assert outs[1].finish_reason == "error"
    for rid in (0, 2):
        assert outs[rid].finish_reason in ("eos", "length"), outs[rid]
    with pytest.raises(KeyError, match="unregistered"):
        ServingGateway(reg, chunk_size=8, device="cpu",
                       faults={"nope": plan})


# ---------------------------------------------------------------------------
# HTTP front door
# ---------------------------------------------------------------------------

async def _call(host, port, method, path, body=None, headers=None):
    reader, writer = await asyncio.open_connection(host, port)
    payload = b"" if body is None else json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Length: {len(payload)}\r\n" + extra
                  + "Connection: close\r\n\r\n").encode() + payload)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    ctype = ""
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode().partition(":")
        if k.strip().lower() == "content-type":
            ctype = v.strip()
    raw = await reader.read()
    writer.close()
    if "event-stream" in ctype:
        events, sid = [], None
        for line in raw.decode().splitlines():
            if line.startswith("id: "):
                sid = int(line[4:])
            elif line.startswith("data: "):
                data = line[6:]
                events.append((sid, data if data == "[DONE]"
                               else json.loads(data)))
                sid = None
        return status, events
    return status, json.loads(raw or b"{}")


def test_http_models_completions_404_and_streaming(tiny, monkeypatch):
    """The reference's HTTP test, plus the thread rule: every gateway call
    that may touch the device (intake, cancel, steps) runs on the pump
    thread, never on the event loop's or an executor's."""
    cfg, base, var = tiny
    gw = ServingGateway(_registry(cfg, base, var), batch_slots=2,
                        buffer_len=64, chunk_size=8, device="cpu")
    threads = set()
    for name in ("add_request", "step", "cancel"):
        orig = getattr(gw, name)

        def spy(*a, _orig=orig, **kw):
            threads.add(threading.current_thread().name)
            return _orig(*a, **kw)
        monkeypatch.setattr(gw, name, spy)

    async def drive():
        srv = GatewayHTTPServer(gw, port=0)
        await srv.start()
        try:
            h = srv.host, srv.port
            st, models = await _call(*h, "GET", "/v1/models")
            assert st == 200
            assert sorted(m["id"] for m in models["data"]) == ["m-a", "m-b"]
            c1, c2, nf, sse = await asyncio.gather(
                _call(*h, "POST", "/v1/completions",
                      {"model": "m-a", "prompt": [3, 1, 4], "max_tokens": 4}),
                _call(*h, "POST", "/v1/completions",
                      {"model": "m-b", "prompt": [3, 1, 4], "max_tokens": 4,
                       "temperature": 0.8, "top_k": 20, "seed": 7}),
                _call(*h, "POST", "/v1/completions",
                      {"model": "ghost", "prompt": [1]}),
                _call(*h, "POST", "/v1/completions",
                      {"model": "m-a", "prompt": [3, 1, 4], "max_tokens": 4,
                       "stream": True}))
            for st, resp in (c1, c2):
                assert st == 200
                ch = resp["choices"][0]
                assert ch["finish_reason"] in ("eos", "length")
                assert len(ch["token_ids"]) <= 4
                assert resp["usage"]["prompt_tokens"] == 3
            assert nf[0] == 404
            assert nf[1]["error"]["code"] == "model_not_found"
            st, events = sse
            assert st == 200 and events[-1][1] == "[DONE]"
            toks = [e["choices"][0]["token"] for _sid, e in events[:-1]
                    if e["choices"][0].get("token") is not None]
            assert toks == c1[1]["choices"][0]["token_ids"]
            return srv._pump_thread.name
        finally:
            await srv.stop()

    pump = asyncio.run(drive())
    assert threads == {pump}


def _one_model_gateway(cfg, params, journal):
    reg = ModelRegistry()
    reg.register("m", cfg, lambda: params)
    return ServingGateway(reg, batch_slots=2, buffer_len=64, chunk_size=8,
                          device="cpu", journal=journal)


def test_http_idempotency_attach_replay_conflict_and_sse_resume(
        tiny, tmp_path):
    cfg, base, _ = tiny
    j = RequestJournal(str(tmp_path / "j"))
    gw = _one_model_gateway(cfg, base, j)
    body = {"model": "m", "prompt": [3, 1, 4], "max_tokens": 4,
            "idempotency_key": "key-a"}

    async def drive():
        srv = GatewayHTTPServer(gw, port=0)
        await srv.start()
        try:
            h = srv.host, srv.port
            t1 = asyncio.ensure_future(
                _call(*h, "POST", "/v1/completions", body))
            await asyncio.sleep(0.3)
            s2, r2 = await _call(*h, "POST", "/v1/completions", body)
            s1, r1 = await t1
            assert s1 == 200 and s2 == 200
            toks = r1["choices"][0]["token_ids"]
            assert toks == r2["choices"][0]["token_ids"]
            assert r1["id"] == r2["id"]
            s3, r3 = await _call(*h, "POST", "/v1/completions", body)
            assert s3 == 200 and r3["choices"][0]["token_ids"] == toks
            s4, r4 = await _call(*h, "POST", "/v1/completions",
                                 dict(body, prompt=[9, 9]))
            assert s4 == 409
            assert r4["error"]["code"] == "idempotency_conflict"
            s5, r5 = await _call(*h, "POST", "/v1/completions",
                                 {"model": "m", "prompt": [3, 1, 4],
                                  "max_tokens": 4},
                                 headers={"Idempotency-Key": "key-a"})
            assert s5 == 200 and r5["choices"][0]["token_ids"] == toks
            s6, ev6 = await _call(*h, "POST", "/v1/completions",
                                  dict(body, stream=True))
            ids = [sid for sid, e in ev6
                   if e != "[DONE]" and e["choices"][0].get("token")
                   is not None]
            assert ids == list(range(len(toks)))
            s7, ev7 = await _call(*h, "POST", "/v1/completions",
                                  dict(body, stream=True),
                                  headers={"Last-Event-ID": "1"})
            resumed = [(sid, e["choices"][0]["token"]) for sid, e in ev7
                       if e != "[DONE]" and e["choices"][0].get("token")
                       is not None]
            assert resumed == [(i, toks[i]) for i in range(2, len(toks))]
        finally:
            await srv.stop()

    asyncio.run(drive())
    j.close()


def test_http_idempotency_survives_restart(tiny, tmp_path):
    cfg, base, _ = tiny
    d = str(tmp_path / "j")
    body = {"model": "m", "prompt": [3, 1, 4], "max_tokens": 4,
            "temperature": 0.8, "top_k": 8, "seed": 5,
            "idempotency_key": "key-r"}

    async def run_once(journal, out):
        gw = _one_model_gateway(cfg, base, journal)
        srv = GatewayHTTPServer(gw, port=0)
        await srv.start()
        try:
            out["recovered"] = await srv.recover()
            st, resp = await _call(srv.host, srv.port, "POST",
                                   "/v1/completions", body)
            assert st == 200
            out["rid"] = resp["id"]
            out["tokens"] = resp["choices"][0]["token_ids"]
            st, resp = await _call(srv.host, srv.port, "POST",
                                   "/v1/completions",
                                   dict(body, max_tokens=9))
            out["conflict"] = st
        finally:
            await srv.stop()

    first: dict = {}
    j1 = RequestJournal(d)
    asyncio.run(run_once(j1, first))
    j1.close()
    assert first["conflict"] == 409
    second: dict = {}
    j2 = RequestJournal(d)
    asyncio.run(run_once(j2, second))
    j2.close()
    assert second["recovered"] == 0
    assert second["tokens"] == first["tokens"]
    assert second["rid"] == first["rid"]
    assert second["conflict"] == 409


# ---------------------------------------------------------------------------
# The CI gateway lines through the port's launcher (--device cpu)
# ---------------------------------------------------------------------------

_MODELS = "tinyllama_1_1b:tl-a,tinyllama_1_1b:tl-b,qwen2_5_14b:qw"
_CI_LINES = {
    "smoke": ["--models", _MODELS, "--self-test", "8"],
    "nan_scoped": ["--models", _MODELS, "--self-test", "8",
                   "--inject", "nan:step=3", "--inject-model", "qw"],
    "fleet_chaos": ["--models", _MODELS, "--max-new", "8", "--replicas",
                    "2", "--dead-after", "1", "--scrub-every", "2",
                    "--inject", "fail:step=2", "--inject", "flip:step=3",
                    "--inject-model", "tl-a", "--self-test", "12"],
}


@pytest.mark.parametrize("line", sorted(_CI_LINES))
def test_ci_gateway_line_on_cpu(line, capsys):
    tlaunch.main(["--smoke", "--chunk-size", "8", "--device", "cpu"]
                 + _CI_LINES[line])
    out = capsys.readouterr().out
    assert "graceful drain OK" in out
    if line == "fleet_chaos":
        assert "failover OK" in out and "scrub OK" in out


def test_ci_gateway_kill9_line_on_cpu(tmp_path, capsys):
    """The supervised kill-9 line: the child gateway dies at its step 5,
    restarts, and every request finishes exactly once, fp32 streams
    byte-identical to the fault-free re-run."""
    tlaunch.main(["--smoke", "--models",
                  "tinyllama_1_1b:tl-a,tinyllama_1_1b:tl-b",
                  "--chunk-size", "8", "--device", "cpu", "--max-new", "8",
                  "--journal", str(tmp_path / "gw"), "--supervise",
                  "--self-test", "6", "--inject", "die:step=5",
                  "--port", "0"])
    out = capsys.readouterr().out
    assert "kill-9 smoke OK: 1 restart(s)" in out
    assert "6/6 recovered streams byte-identical" in out
