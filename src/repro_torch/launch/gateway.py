"""Multi-model gateway launcher of the port: registry + HTTP front door in
one command (port of ``repro.launch.gateway``).

  PYTHONPATH=src python -m repro_torch.launch.gateway --smoke \
      --models tinyllama_1_1b:tl-a,tinyllama_1_1b:tl-b --chunk-size 8 \
      --alpha-budget-mb 64 --port 8080 [--device cpu] [--dtype float32]

Runs on the GPU unless ``--device cpu`` is given (it raises when no GPU is
present); ``--dtype`` overrides the configs' model dtype, as on
``repro_torch.launch.serve``. Parameters are initialised natively from
``--seed`` on the device (``models.registry.model_init``). On the GPU every
engine step replays a CUDA graph, one per step shape and engine.

``--models`` is a comma-separated list of ``arch[:alias]`` entries. Each
architecture's FIRST entry gets its seeded base init; REPEATED entries of
the same architecture become same-architecture variants (the alpha banks
are deterministically perturbed per occurrence — the "fine-tune touched
the alphas" story), so they stack into ONE multi-model engine and batch
together. Distinct architectures get their own pool engine and round-robin.
``--alpha-budget-mb`` arms the registry's byte budget: the LRU unpinned
group is evicted when a load would exceed it, and a model that cannot be
made resident is refused with 503 (``model_evicted``), never silently
queued cold. A single-model group's engine plans its OVSF layers with the
mapper for the device (``fused`` on the GPU); a stacked group's runs the
multi-model spectral path (``kernels.ops.ovsf_matmul_multi``).

Fleet fault tolerance:

* ``--replicas N`` runs every engine group as N replicas sharing the same
  resident alpha bank; ``--degraded-after``/``--dead-after`` set the
  health thresholds (a DEAD replica drains and its in-flight requests
  fail over to survivors token-identically).
* ``--scrub-every K`` arms the alpha-bank integrity scrub every K gateway
  steps; an injected ``flip`` fault (``--inject flip:step=3``) corrupts
  the resident bank so the scrub has a real bit-flip to detect and repair.
* ``--breaker-after M`` arms per-model circuit breakers at the front door
  (M consecutive error completions -> 503 + Retry-After, half-open probe
  after ``--breaker-cooldown`` seconds).
* The server always exposes the admin surface: ``POST /admin/models``
  (hot ADD via this launcher's model factory), ``DELETE
  /admin/models/<id>``, ``POST /admin/drain`` (graceful drain), ``GET
  /admin/health``.

``--self-test N`` starts the server on an ephemeral port, drives N
concurrent HTTP requests round-robin across the registered models (mixed
greedy/sampled, one streaming, plus one deliberate unknown-model request
that must 404), then exercises the client-error contract (malformed JSON
and bad sampling params must 400, never 500), the hot ADD/REMOVE admin
routes, and a graceful drain — and exits non-zero unless every response
is well-formed, every finish reason is attributable to what this
invocation configured, and ZERO requests were lost. With ``--replicas 2
--dead-after 1 --inject fail:step=5`` the self-test additionally requires
at least one replica failover; with ``--scrub-every K --inject
flip:step=S`` it requires the scrub to have detected and repaired the
injected corruption. The CI fleet-chaos smoke rides exactly this
contract.

Durability (see ``docs/serving.md`` "Durability & crash recovery"):
``--journal DIR`` arms the write-ahead request journal and crash-safe
restart — the HTTP front door gains idempotency-key dedupe (exactly-once
across retries AND crashes), SSE ``id:``/``Last-Event-ID`` stream resume,
and journal replay on startup. ``--supervise`` (requires ``--journal``)
runs the gateway as a child process under a restart loop and drives the
crash-aware self-test client from THIS process: ``--inject die:step=N``
hard-kills the child mid-step (``os._exit`` — no flush, no goodbye), the
supervisor (``launch.supervise``'s ``die_armed`` / ``strip_die``) restarts
it with the ``die`` injector stripped, and the client
must see every request finish exactly once with zero lost and zero
duplicated tokens, byte-identical to a fault-free run. The CI kill-9
smoke rides exactly this contract. Byte identity is held in float32: in
bfloat16 a recomputed context rounds otherwise than the first pass did
(chunk vs decode shapes), so recovered bf16 streams may part from the
fault-free run; the launcher then prints how many agree.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import socket
import subprocess
import sys
import time

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import registry as R
from repro_torch.runtime.faults import DIE_EXIT_CODE, FaultPlan
from repro_torch.serving import HealthPolicy, ModelRegistry, RequestJournal
from repro_torch.serving.gateway import GatewayHTTPServer, ServingGateway
from repro_torch.serving.model_registry import (dense_fp32_bytes,
                                                make_alpha_variant)


def parse_models(spec: str) -> list:
    """``arch[:alias],...`` -> [(arch, alias, occurrence_index)]."""
    out = []
    counts: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        arch, _, alias = item.partition(":")
        k = counts.get(arch, 0)
        counts[arch] = k + 1
        if not alias:
            alias = arch if k == 0 else f"{arch}-{k}"
        out.append((arch, alias, k))
    if not out:
        raise SystemExit("--models: no models parsed")
    names = [a for _, a, _ in out]
    if len(set(names)) != len(names):
        raise SystemExit(f"--models: duplicate aliases in {names}")
    return out


def load_config(arch: str, smoke: bool, dtype: str = ""):
    """The architecture's config (its smoke variant with ``smoke``), in
    ``dtype`` when given."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return cfg.replace(dtype=dtype) if dtype else cfg


def make_loader(cfg, seed: int, k: int, device):
    """Loader that re-materialises params bitwise on ``device``: occurrence
    k of an architecture is its seeded base init for k == 0 and a
    deterministic alpha perturbation of that base for k > 0 (a seeded
    ``torch.Generator`` on the device draws the same numbers every time).
    Bitwise reloads are what make scrub REPAIR possible (the ledger must
    verify)."""
    def loader():
        base = R.model_init(cfg, seed, device)
        if k == 0:
            return base
        return make_alpha_variant(base, seed=seed + k)
    return loader


def build_registry(models: list, smoke: bool, seed: int, device,
                   budget_bytes=None, dtype: str = "") -> ModelRegistry:
    reg = ModelRegistry(budget_bytes=budget_bytes)
    for arch, alias, k in models:
        cfg = load_config(arch, smoke, dtype)
        reg.register(alias, cfg, make_loader(cfg, seed, k, device),
                     tags=(arch, f"variant-{k}"))
    return reg


def make_model_factory(smoke: bool, seed: int, device, dtype: str = ""):
    """``POST /admin/models`` body -> (name, cfg, loader, tags). The body
    is ``{"arch": ..., "id": ..., "variant": k}``; KeyError/ValueError
    surface as HTTP 400. Host work only: the loader runs later, on the
    gateway's pump thread."""
    def factory(spec: dict):
        arch = spec["arch"]                   # KeyError -> 400
        name = spec.get("id") or arch
        k = spec.get("variant", 0)
        if isinstance(k, bool) or not isinstance(k, int) or k < 0:
            raise ValueError("'variant' must be a non-negative integer")
        if not isinstance(name, str) or not name:
            raise ValueError("'id' must be a non-empty string")
        try:
            cfg = load_config(arch, smoke, dtype)
        except (KeyError, ModuleNotFoundError):
            raise ValueError(f"unknown architecture {arch!r}")
        return (name, cfg, make_loader(cfg, seed, k, device),
                (arch, f"variant-{k}", "hot-added"))
    return factory


async def _http(host: str, port: int, method: str, path: str,
                body=None, raw_body: bytes = None,
                req_headers: dict = None) -> tuple:
    """One HTTP exchange; returns (status, parsed-JSON-or-SSE-events,
    headers). SSE events carry their ``id:`` line (the absolute token
    index, the ``Last-Event-ID`` resume cursor) as ``_sse_id``; truncated
    trailing events (the server died mid-stream) are dropped, not raised —
    the durable client retries and resumes past what it already has."""
    reader, writer = await asyncio.open_connection(host, port)
    if raw_body is not None:
        payload = raw_body
    else:
        payload = b"" if body is None else json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (req_headers or {}).items())
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Length: {len(payload)}\r\n" + extra +
                  "Connection: close\r\n\r\n").encode() + payload)
    await writer.drain()
    status_line = await reader.readline()
    status = int(status_line.split()[1])
    headers: dict = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    raw = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except Exception:
        pass
    if "event-stream" in headers.get("content-type", ""):
        events = []
        sse_id = None
        for line in raw.decode(errors="replace").splitlines():
            if line.startswith("id: "):
                try:
                    sse_id = int(line[len("id: "):])
                except ValueError:
                    sse_id = None
            elif line.startswith("data: "):
                data = line[len("data: "):]
                if data == "[DONE]":
                    events.append(data)
                    continue
                try:
                    ev = json.loads(data)
                except ValueError:
                    continue            # torn tail: server died mid-event
                if isinstance(ev, dict):
                    ev["_sse_id"] = sse_id
                events.append(ev)
                sse_id = None
        return status, events, headers
    body_txt = raw.split(b"\r\n\r\n")[-1] if b"\r\n\r\n" in raw else raw
    return status, json.loads(body_txt or b"{}"), headers


async def _check_client_errors(host: str, port: int, model: str) -> None:
    """Client bugs must map to 400 with an OpenAI-style error object —
    never 500 — and every 503 must carry Retry-After."""
    status, body, _ = await _http(host, port, "POST", "/v1/completions",
                                  raw_body=b"{not json!")
    if status != 400 or body["error"]["type"] != "invalid_request_error":
        raise SystemExit(f"[gateway] FAILED: malformed JSON -> {status} "
                         f"{body} (want 400 invalid_request_error)")
    for bad in ({"temperature": "hot"}, {"max_tokens": 0},
                {"top_k": -1}, {"prompt": {"oops": 1}},
                {"stream": "yes"}, {"deadline_s": -2}):
        req = {"model": model, "prompt": [1]}
        req.update(bad)
        status, body, _ = await _http(host, port, "POST",
                                      "/v1/completions", req)
        if status != 400:
            raise SystemExit(f"[gateway] FAILED: bad param {bad} -> "
                             f"{status} {body} (want 400)")
    print("[gateway] client-error contract OK (400s, never 500s)")


async def _check_admin(srv: GatewayHTTPServer, arch: str,
                       injected: set) -> None:
    """Hot ADD -> serve -> duplicate 409 -> REMOVE -> 404 contract."""
    host, port = srv.host, srv.port
    spec = {"arch": arch, "id": "hot-add-test", "variant": 9}
    status, body, _ = await _http(host, port, "POST", "/admin/models", spec)
    if status != 200 or body.get("id") != "hot-add-test":
        raise SystemExit(f"[gateway] FAILED: hot ADD -> {status} {body}")
    status, models, _ = await _http(host, port, "GET", "/v1/models")
    listed = [m["id"] for m in models["data"]]
    if "hot-add-test" not in listed:
        raise SystemExit(f"[gateway] FAILED: hot model not listed: {listed}")
    # the hot model must actually serve (it joined arch's engine group)
    group = srv.gateway.registry.entries["hot-add-test"].group
    allowed = {"eos", "length"}
    if any(srv.gateway.registry.entries[n].group == group
           for n in injected if srv.gateway.registry.get(n)):
        allowed.add("error")
    status, resp, _ = await _http(host, port, "POST", "/v1/completions",
                                  {"model": "hot-add-test",
                                   "prompt": [7, 11, 13], "max_tokens": 4})
    reason = resp.get("choices", [{}])[0].get("finish_reason")
    if status != 200 or reason not in allowed:
        raise SystemExit(f"[gateway] FAILED: hot model completion -> "
                         f"{status} {reason}")
    status, body, _ = await _http(host, port, "POST", "/admin/models", spec)
    if status != 409:
        raise SystemExit(f"[gateway] FAILED: duplicate ADD -> {status} "
                         f"(want 409)")
    status, body, _ = await _http(host, port, "DELETE",
                                  "/admin/models/hot-add-test")
    if status != 200:
        raise SystemExit(f"[gateway] FAILED: hot REMOVE -> {status} {body}")
    status, body, _ = await _http(host, port, "DELETE",
                                  "/admin/models/hot-add-test")
    if status != 404:
        raise SystemExit(f"[gateway] FAILED: double REMOVE -> {status} "
                         f"(want 404)")
    print("[gateway] admin hot ADD/REMOVE OK (200 -> serve -> 409 -> 404)")


async def self_test(srv: GatewayHTTPServer, names: list, n: int,
                    injected: set, max_new: int, arch0: str,
                    expect_failover: bool = False,
                    expect_scrub: bool = False) -> None:
    """Concurrent client drive of the just-started server (see module
    docstring for the pass criteria). Raises SystemExit on violation."""
    host, port = srv.host, srv.port

    async def completion(i: int) -> tuple:
        model = names[i % len(names)]
        sampled = i % 3 == 2
        body = {"model": model, "prompt": [2 + i, 3, 5 + i],
                "max_tokens": max_new,
                "temperature": 0.8 if sampled else 0.0,
                "top_k": 20 if sampled else 0, "seed": i,
                "stream": i == 1}
        status, resp, _ = await _http(host, port, "POST", "/v1/completions",
                                      body)
        if i == 1:   # streaming: fold SSE events into a completion-like dict
            toks = [e["choices"][0]["token"] for e in resp
                    if e != "[DONE]" and e["choices"][0].get("token")
                    is not None]
            fins = [e["choices"][0]["finish_reason"] for e in resp
                    if e != "[DONE]"]
            if resp[-1] != "[DONE]":
                raise SystemExit("[gateway] FAILED: stream missing [DONE]")
            return model, status, toks, fins[-1]
        ch = resp.get("choices", [{}])[0]
        return (model, status, ch.get("token_ids", []),
                ch.get("finish_reason"))

    status, models, _ = await _http(host, port, "GET", "/v1/models")
    listed = sorted(m["id"] for m in models.get("data", []))
    if status != 200 or listed != sorted(names):
        raise SystemExit(f"[gateway] FAILED: /v1/models -> {status} {listed}")

    results = await asyncio.gather(
        *[completion(i) for i in range(n)],
        _http(host, port, "POST", "/v1/completions",
              {"model": "no-such-model", "prompt": [1]}))
    nf_status, nf_body, _ = results[-1]
    if nf_status != 404 or nf_body["error"]["code"] != "model_not_found":
        raise SystemExit(f"[gateway] FAILED: unknown model -> {nf_status} "
                         f"{nf_body}")
    bad = []
    for model, status, toks, reason in results[:-1]:
        allowed = {"eos", "length"}
        if model in injected:
            allowed.add("error")   # the deliberately-poisoned engine only
        if status != 200 or reason not in allowed:
            bad.append((model, status, reason))
        elif reason == "length" and len(toks) != max_new:
            bad.append((model, status, f"{len(toks)} tokens"))
    if bad:
        raise SystemExit(f"[gateway] FAILED: bad completions: {bad}")
    # ZERO lost requests: every submitted completion came back terminal
    print(f"[gateway] self-test OK: {n} completions + 404 + streaming "
          f"(quarantine scope: {sorted(injected) or 'none'})")

    s = srv.gateway.stats
    if expect_failover and s.failovers < 1:
        raise SystemExit(
            f"[gateway] FAILED: expected a replica failover under the "
            f"injected kill (failovers={s.failovers}, "
            f"replicas_dead={s.replicas_dead})")
    if expect_failover:
        print(f"[gateway] failover OK: {s.failovers} failover(s), "
              f"{s.failover_requests} request(s) migrated, zero lost")
    if expect_scrub and (s.corruptions_injected < 1 or s.scrub_repairs < 1):
        raise SystemExit(
            f"[gateway] FAILED: expected the scrub to detect+repair the "
            f"injected flip (injected={s.corruptions_injected}, "
            f"caught={s.scrub_corruptions}, repaired={s.scrub_repairs})")
    if expect_scrub:
        print(f"[gateway] scrub OK: {s.corruptions_injected} flip(s) "
              f"injected, {s.scrub_corruptions} caught, "
              f"{s.scrub_repairs} repaired bitwise")

    status, health, _ = await _http(host, port, "GET", "/admin/health")
    if status != 200 or "models" not in health:
        raise SystemExit(f"[gateway] FAILED: /admin/health -> {status}")
    await _check_client_errors(host, port, names[0])
    await _check_admin(srv, arch0, injected)

    # graceful drain: stop admission (503 + Retry-After), finish live
    # work, and fire the drained event the launcher exits 0 on
    status, body, _ = await _http(host, port, "POST", "/admin/drain")
    if status != 200:
        raise SystemExit(f"[gateway] FAILED: /admin/drain -> {status}")
    status, body, hdrs = await _http(host, port, "POST", "/v1/completions",
                                     {"model": names[0], "prompt": [1]})
    if status != 503 or "retry-after" not in hdrs:
        raise SystemExit(f"[gateway] FAILED: draining admission -> {status} "
                         f"headers={sorted(hdrs)} (want 503 + Retry-After)")
    try:
        await asyncio.wait_for(srv.drained.wait(), timeout=60)
    except asyncio.TimeoutError:
        raise SystemExit("[gateway] FAILED: drain never completed")
    print("[gateway] graceful drain OK (admission 503 + Retry-After, "
          "live work finished)")


def _free_port(host: str) -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def _retrying(fn, *, what: str, timeout_s: float = 240.0):
    """Run one client exchange against a gateway that may be dead or mid-
    restart underneath it: connection errors, torn responses, and 503s
    retry until the supervisor brings the server back (or the deadline
    passes — a real hang must still fail the smoke)."""
    deadline = time.perf_counter() + timeout_s
    while True:
        try:
            return await fn()
        except (OSError, ValueError, KeyError, IndexError) as e:
            if time.perf_counter() > deadline:
                raise SystemExit(f"[supervise] FAILED: {what} never "
                                 f"succeeded: {type(e).__name__}: {e}")
            await asyncio.sleep(0.25)


async def kill9_self_test(host: str, port: int, names: list, n: int,
                          max_new: int, exact: bool = True) -> None:
    """The crash-aware client of the kill-9 smoke, driven from the
    SUPERVISOR process so it outlives the gateway's injected death: ``n``
    durable completions with idempotency keys (one streaming, resumed via
    ``Last-Event-ID``), retried across the crash, then the durability
    contracts:

    * zero lost — every request reaches eos/length exactly once;
    * zero duplicates — no SSE token id is delivered twice, ids are
      gapless from 0 across reconnects;
    * exactly-once — re-POSTing each key replays the SAME tokens; reusing
      a key with a different body is 409 ``idempotency_conflict``;
    * byte identity — a fresh fault-free re-run of every prompt (new
      keys, post-restart, die injector stripped) matches the streams that
      crossed the crash (``exact``: the models run in float32; otherwise
      the agreement is printed, module docstring).
    """
    def body_for(i: int) -> dict:
        sampled = i % 3 == 2
        return {"model": names[i % len(names)], "prompt": [2 + i, 3, 5 + i],
                "max_tokens": max_new,
                "temperature": 0.8 if sampled else 0.0,
                "top_k": 20 if sampled else 0, "seed": i}

    async def post(body, hdrs=None) -> tuple:
        status, resp, _ = await _http(host, port, "POST", "/v1/completions",
                                      body, req_headers=hdrs)
        if status == 503:
            raise OSError("gateway restarting/draining (503)")
        return status, resp

    async def durable(i: int) -> tuple:
        body = dict(body_for(i), idempotency_key=f"kill9-{i}")

        async def once():
            status, resp = await post(body)
            if status != 200:
                raise SystemExit(f"[supervise] FAILED: request {i} -> "
                                 f"{status} {resp}")
            ch = resp["choices"][0]
            return list(ch.get("token_ids", [])), ch.get("finish_reason")

        return await _retrying(once, what=f"completion {i}")

    async def durable_stream(i: int) -> tuple:
        body = dict(body_for(i), idempotency_key=f"kill9-{i}", stream=True)
        toks: dict = {}                   # absolute SSE token id -> token
        state = {"last": -1, "fin": None, "dups": 0}

        async def once():
            status, events = await post(
                body, hdrs={"Last-Event-ID": str(state["last"])})
            if status != 200:
                raise SystemExit(f"[supervise] FAILED: stream {i} -> "
                                 f"{status} {events}")
            for ev in events:
                if ev == "[DONE]":
                    continue
                ch = ev["choices"][0]
                if ch.get("token") is not None:
                    sid = ev.get("_sse_id")
                    if sid is None:
                        raise SystemExit(f"[supervise] FAILED: stream {i} "
                                         f"token without an id: {ev}")
                    if sid in toks:
                        state["dups"] += 1
                    toks[sid] = ch["token"]
                    state["last"] = max(state["last"], sid)
                elif ch.get("finish_reason"):
                    state["fin"] = ch["finish_reason"]
            if state["fin"] is None:      # stream cut mid-flight: resume
                raise OSError("stream severed before finish (server died)")

        await _retrying(once, what=f"stream {i}")
        ids = sorted(toks)
        if state["dups"] or ids != list(range(len(ids))):
            raise SystemExit(f"[supervise] FAILED: stream {i} token ids "
                             f"duplicated or gapped: dups={state['dups']} "
                             f"ids={ids}")
        return [toks[k] for k in ids], state["fin"]

    t0 = time.perf_counter()
    results = await asyncio.gather(
        *[durable_stream(i) if i == 1 else durable(i) for i in range(n)])
    bad = [(i, r[1]) for i, r in enumerate(results)
           if r[1] not in ("eos", "length")]
    if bad:
        raise SystemExit(f"[supervise] FAILED: bad finish reasons: {bad}")
    print(f"[supervise] {n} durable completions survived the kill "
          f"({time.perf_counter() - t0:.1f}s, zero lost, "
          f"zero duplicated)")

    # exactly-once: replaying every key must serve the durable record
    # (identical tokens), never start a second execution
    for i in range(n):
        async def replay(b=dict(body_for(i), idempotency_key=f"kill9-{i}")):
            status, resp = await post(b)
            if status != 200:
                raise SystemExit(f"[supervise] FAILED: idempotent replay "
                                 f"-> {status} {resp}")
            return resp
        resp = await _retrying(replay, what=f"idempotent replay {i}")
        got = list(resp["choices"][0].get("token_ids", []))
        if got != list(results[i][0]):
            raise SystemExit(f"[supervise] FAILED: idempotent replay {i} "
                             f"diverged: {got} != {results[i][0]}")

    # reusing a key with a DIFFERENT body must 409, never execute
    async def conflict():
        return await post(dict(body_for(0), prompt=[9, 9, 9],
                               idempotency_key="kill9-0"))
    status, resp = await _retrying(conflict, what="conflict check")
    if status != 409 or resp.get("error", {}).get("code") != \
            "idempotency_conflict":
        raise SystemExit(f"[supervise] FAILED: key reuse with different "
                         f"body -> {status} {resp} (want 409)")

    # byte identity: fresh keys re-run every prompt fault-free (the die
    # injector is stripped post-restart) — the reference the recovered
    # streams must match exactly
    same = 0
    for i in range(n):
        async def fresh(b=dict(body_for(i), idempotency_key=f"ref-{i}")):
            status, resp = await post(b)
            if status != 200:
                raise SystemExit(f"[supervise] FAILED: reference {i} -> "
                                 f"{status} {resp}")
            return resp
        resp = await _retrying(fresh, what=f"reference {i}")
        ref = list(resp["choices"][0].get("token_ids", []))
        same += ref == list(results[i][0])
        if exact and ref != list(results[i][0]):
            raise SystemExit(f"[supervise] FAILED: recovered stream {i} is "
                             f"not byte-identical to the fault-free "
                             f"reference: {results[i][0]} vs {ref}")
    print(f"[supervise] exactly-once replay + 409 conflict OK; {same}/{n} "
          f"recovered streams byte-identical to the fault-free reference"
          + (" (held)" if exact else " (bf16: printed, held in float32)"))


def _supervised_main(args, raw_argv: list) -> None:
    """``--supervise``: run the gateway as a child process under a restart
    loop and drive the crash-aware client from THIS process (the client
    must outlive the gateway's injected ``os._exit``)."""
    from repro_torch.launch.supervise import (MAX_RESTARTS, die_armed,
                                              strip_die)
    if not args.journal:
        raise SystemExit("--supervise requires --journal: a crash without "
                         "a journal loses every live request")
    models = parse_models(args.models)
    names = [alias for _, alias, _ in models]
    exact = all(load_config(arch, args.smoke, args.dtype).dtype == "float32"
                for arch, _a, _k in models)
    port = args.port or _free_port(args.host)
    child: list = []
    skip = False
    for a in raw_argv:                  # child serves forever on a fixed
        if skip:                        # port; the client runs up here
            skip = False
            continue
        if a == "--supervise":
            continue
        if a in ("--self-test", "--port"):
            skip = True
            continue
        if a.startswith("--self-test=") or a.startswith("--port="):
            continue
        child.append(a)
    child += ["--port", str(port)]
    n = args.self_test or 6
    armed = die_armed(child)
    state = {"argv": child, "proc": None, "restarts": 0, "done": False}

    def spawn():
        state["proc"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.gateway"]
            + state["argv"])

    async def monitor():
        while not state["done"]:
            rc = state["proc"].poll()
            if rc is None:
                await asyncio.sleep(0.05)
                continue
            if rc == DIE_EXIT_CODE and state["restarts"] < MAX_RESTARTS:
                state["restarts"] += 1
                state["argv"] = strip_die(state["argv"])
                print(f"[supervise] gateway hard-killed (injected die, "
                      f"exit {rc}); restart #{state['restarts']} with die "
                      f"injector stripped")
                spawn()
                continue
            raise SystemExit(f"[supervise] FAILED: gateway exited {rc} "
                             f"mid-test")

    async def drive() -> None:
        spawn()
        mon = asyncio.ensure_future(monitor())
        client = asyncio.ensure_future(
            kill9_self_test(args.host, port, names, n, args.max_new, exact))
        try:
            done, _ = await asyncio.wait(
                {mon, client}, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                if t.exception() is not None:
                    raise t.exception()
        finally:
            state["done"] = True
            for t in (mon, client):
                t.cancel()
            await asyncio.gather(mon, client, return_exceptions=True)
            if state["proc"] is not None and state["proc"].poll() is None:
                state["proc"].terminate()
                state["proc"].wait()

    asyncio.run(drive())
    if armed and state["restarts"] < 1:
        raise SystemExit("[supervise] FAILED: a die fault was armed but "
                         "the gateway never died — the kill-9 smoke "
                         "proved nothing")
    print(f"[supervise] kill-9 smoke OK: {state['restarts']} restart(s), "
          f"{n} requests exactly once across the crash")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", required=True,
                    help="comma-separated arch[:alias]; repeated archs "
                         "become stacked same-architecture variants")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="", choices=["", "bfloat16", "float32"],
                    help="model dtype (default: the configs'); in float32 "
                         "a recomputed context rounds as the first pass "
                         "did, so recovered streams can be held equal")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--buffer", type=int, default=128)
    ap.add_argument("--chunk-size", type=int, default=16)
    ap.add_argument("--alpha-budget-mb", type=float, default=None,
                    help="registry byte budget; LRU groups evict past it "
                         "and unloadable models are refused with 503")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas per model group (shared alpha "
                         "bank; health-checked failover between them)")
    ap.add_argument("--degraded-after", type=int, default=1,
                    help="incident points before a replica is DEGRADED")
    ap.add_argument("--dead-after", type=int, default=3,
                    help="incident points before a replica is DEAD "
                         "(drained + failed over)")
    ap.add_argument("--scrub-every", type=int, default=0, metavar="K",
                    help="alpha-bank CRC scrub cadence in gateway steps "
                         "(0 = off)")
    ap.add_argument("--breaker-after", type=int, default=0, metavar="M",
                    help="per-model circuit breaker: M consecutive error "
                         "completions -> 503 + Retry-After (0 = off)")
    ap.add_argument("--breaker-cooldown", type=float, default=2.0,
                    help="seconds an open breaker waits before half-open")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--inject", action="append", default=[],
                    metavar="KIND:KEY=V,...",
                    help="deterministic faults for --inject-model only "
                         "(same grammar as repro_torch.launch.serve, plus "
                         "flip:step=N[,leaf=L,bit=B] bank corruption)")
    ap.add_argument("--inject-model", default=None,
                    help="model alias the --inject plan is scoped to "
                         "(default: the first registered model)")
    ap.add_argument("--self-test", type=int, default=0, metavar="N",
                    help="serve, drive N concurrent HTTP requests, verify "
                         "the exit contract, and exit (CI smoke mode)")
    ap.add_argument("--journal", default="",
                    help="write-ahead request journal directory: arms "
                         "crash-safe restart, idempotency-key dedupe, and "
                         "SSE Last-Event-ID resume")
    ap.add_argument("--supervise", action="store_true",
                    help="restart-supervisor mode (requires --journal): "
                         "the gateway runs as a child, an injected die "
                         "fault kills it for real, and the crash-aware "
                         "self-test client must see exactly-once results")
    args = ap.parse_args(argv)

    if args.supervise:
        _supervised_main(args, list(sys.argv[1:] if argv is None else argv))
        return

    device = resolve_device(args.device)
    models = parse_models(args.models)
    names = [alias for _, alias, _ in models]
    budget = (None if args.alpha_budget_mb is None
              else int(args.alpha_budget_mb * 1024 * 1024))
    reg = build_registry(models, args.smoke, args.seed, device,
                         budget_bytes=budget, dtype=args.dtype)

    faults = None
    injected: set = set()
    plan = FaultPlan()
    if args.inject:
        target = args.inject_model or names[0]
        if target not in names:
            raise SystemExit(f"--inject-model {target!r} not in {names}")
        plan = FaultPlan.parse(args.inject, seed=args.seed)
        faults = {target: plan}
        # quarantine scope = the target's whole engine (its arch group) —
        # flip faults corrupt only the registry bank (scrub repairs them
        # before they reach a served token), so they don't widen the scope
        if any(f.kind in ("nan", "fail", "delay") for f in plan.faults):
            group = reg.entries[target].group
            injected = {n for n in names if reg.entries[n].group == group}
        print(f"[gateway] chaos: {len(plan.faults)} injector(s) on "
              f"{target!r} (engine scope: {sorted(injected) or 'registry'})")

    journal = RequestJournal(args.journal) if args.journal else None
    gw = ServingGateway(
        reg, batch_slots=args.slots, buffer_len=args.buffer,
        chunk_size=args.chunk_size, device=device, faults=faults,
        replicas=args.replicas,
        health=HealthPolicy(degraded_after=args.degraded_after,
                            dead_after=args.dead_after),
        scrub_every=args.scrub_every, journal=journal)
    largest = max(dense_fp32_bytes(e.cfg) for e in reg.entries.values())
    print(f"[gateway] {len(names)} models in "
          f"{len(reg.groups())} engine group(s) x {args.replicas} "
          f"replica(s) on {device}: {names}")
    print(f"[gateway] budget="
          + (f"{budget/2**20:.1f}MB" if budget else "unbounded")
          + f" dense-fp32(largest)={largest/2**20:.2f}MB")

    expect_failover = (args.replicas > 1 and args.dead_after == 1
                       and any(f.kind == "fail" for f in plan.faults))
    expect_scrub = (args.scrub_every > 0
                    and any(f.kind == "flip" for f in plan.faults))

    async def run() -> None:
        srv = GatewayHTTPServer(
            gw, host=args.host, port=0 if args.self_test else args.port,
            breaker_after=args.breaker_after,
            breaker_cooldown_s=args.breaker_cooldown,
            model_factory=make_model_factory(args.smoke, args.seed, device,
                                             args.dtype))
        await srv.start()
        if journal is not None:
            nrec = await srv.recover()
            ndone = sum(1 for e in journal.entries.values() if e.done)
            if nrec or ndone:
                print(f"[gateway] journal: {nrec} live request(s) "
                      f"recovered mid-stream, {ndone} terminal entries "
                      f"replayable (exactly-once history)")
        print(f"[gateway] listening on http://{srv.host}:{srv.port} "
              f"(completions: POST /v1/completions, admin: /admin/*)")
        if args.self_test:
            t0 = time.perf_counter()
            try:
                await self_test(srv, names, args.self_test, injected,
                                args.max_new, models[-1][0],
                                expect_failover=expect_failover,
                                expect_scrub=expect_scrub)
            finally:
                await srv.stop()
            s = gw.stats
            print(f"[gateway] routed={dict(s.routed)} builds="
                  f"{s.engine_builds} replicas={s.replicas_built} "
                  f"failovers={s.failovers} migrated={s.failover_requests} "
                  f"scrubs={s.scrubs} repaired={s.scrub_repairs} "
                  f"not_found={s.not_found} evicted={s.evicted_refusals} "
                  f"resident={gw.resident_bytes()/2**20:.2f}MB "
                  f"({time.perf_counter()-t0:.1f}s)")
            return
        await srv.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
