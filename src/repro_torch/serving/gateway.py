"""Multi-model serving gateway: replicated engine groups behind one door
(port of ``repro.serving.gateway``).

The gateway routes each request's ``Request.model`` onto engines built from
a :class:`~repro_torch.serving.model_registry.ModelRegistry`:

* **Same-architecture variants batch into ONE engine**: a registry group
  (configs of one architecture signature whose params differ only in their
  alpha banks) serves from one ``LLMEngine(variants=M)`` over the stacked
  params; each slot's tokens contract against its model's alpha bank in
  the same step (``kernels.ops.ovsf_matmul_multi``), so cross-model
  batching captures no step shape beyond the single-model ones, and
  routing a slot to another variant is data (``EngineCore.model_ids``, an
  input of every replayed graph), not a new capture.
* **Replicated groups + health-checked failover**: each group runs
  ``replicas=N`` engines over the same stacked params (replicas share the
  resident alpha bank; each has its own KV cache, slots, graphs and graph
  pools, and all share the device's one warm-up and capture stream). After
  every replica step the gateway books its ``EngineStats`` deltas
  (watchdog recoveries, stalls, NaN quarantines) into a
  :class:`~repro_torch.serving.health.ReplicaHealth`; a replica that
  reaches DEAD is drained (its slots evicted recompute-style) and closed
  (caches, graphs and pools freed), and its requests are adopted by the
  least-loaded survivor, so resumed streams equal the fault-free run's
  (a sampled draw is a pure function of the seed and the tokens emitted).
  When the last replica dies, a clean replacement is built in place.
* **Alpha-bank integrity scrub**: every ``scrub_every`` gateway steps one
  resident group is checked against the CRC32 ledger recorded at its first
  load. A mismatch (an injected ``flip``, applied by the gateway to the
  registry's resident copy at its own step counter: a copy of the leaf in
  a new tree, so engines keep serving their clean tensors) triggers the
  repair: the group drains, its engines close, its params reload from their
  loaders (verified bitwise against the ledger), new engines capture their
  graphs anew, and the drained requests resume through recompute.
* **Byte-budget residency**: engines exist exactly for resident groups; a
  request for an evicted model reloads within the budget or is refused
  with ``FINISH_EVICTED``. :meth:`ServingGateway.add_model` /
  :meth:`remove_model` hot-add and hot-remove models on a live pool
  (:class:`BudgetExceeded` / :class:`ModelInFlight`: the HTTP 409s).
* **HTTP front door**: :class:`GatewayHTTPServer`, a stdlib ``asyncio``
  server with OpenAI-compatible ``GET /v1/models`` and ``POST
  /v1/completions`` (JSON, or SSE with ``"stream": true``), idempotency
  keys with ``Last-Event-ID`` resume, per-model circuit breakers, and the
  admin routes (``POST /admin/models``, ``DELETE /admin/models/<id>``,
  ``POST /admin/drain``, ``GET /admin/health``).

Threads and the device. The engines are stepped by ONE pump thread, and
every tensor operation belongs to it: a step, a capture, a replay, a
registry load, a repair, an engine build or close. The HTTP handlers run on
the event loop and touch host state only; what they need done on the
device (admitting a request, which may load a group and build its engines;
cancelling one; a hot add or remove; the journal's recovery) goes to the
pump as a call it runs between steps, and the handler awaits its result.
The step graphs are captured with ``torch.cuda.graph``'s default
``capture_error_mode="global"`` (``runtime.graphs``): during a capture a
CUDA call from any other thread of the process fails the capture, so no
thread but the pump may touch the device while the server runs.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import queue
import threading
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.serving.api import (FINISH_EVICTED, FINISH_TIMEOUT, Request,
                                     RequestOutput, SamplingParams)
from repro_torch.serving.engine import LLMEngine
from repro_torch.serving.health import (DEAD, HEALTHY, CircuitBreaker,
                                        HealthPolicy, ReplicaHealth)
from repro_torch.serving.journal import body_fingerprint
from repro_torch.serving.model_registry import (ModelRegistry, param_bytes,
                                                stack_variants)

__all__ = ["ServingGateway", "GatewayStats", "GatewayHTTPServer",
           "GatewayRejection", "BudgetExceeded", "ModelInFlight"]


class GatewayRejection(RuntimeError):
    """Admission conflict on a live pool (the HTTP layer's 409)."""
    code = "conflict"


class BudgetExceeded(GatewayRejection):
    """Hot-added model cannot be made resident within the byte budget."""
    code = "budget_exceeded"


class ModelInFlight(GatewayRejection):
    """Hot remove refused: the model still has in-flight requests."""
    code = "model_in_flight"


@dataclasses.dataclass
class GatewayStats:
    requests: int = 0               # add_request calls (incl. refusals)
    routed: dict = dataclasses.field(default_factory=dict)  # model -> count
    not_found: int = 0              # unknown model names
    evicted_refusals: int = 0       # FINISH_EVICTED backpressure responses
    engine_builds: int = 0          # group builds (first build + rebuilds)
    engines_dropped: int = 0        # group drops (eviction / removal)
    reloads: int = 0                # group rebuilds after a prior eviction
    # fleet fault tolerance
    replicas_built: int = 0         # individual engine replicas constructed
    replicas_dead: int = 0          # replicas declared DEAD and drained
    failovers: int = 0              # dead-replica failover events
    failover_requests: int = 0      # in-flight requests migrated by failover
    cancelled: int = 0              # requests cancelled via gateway.cancel
    # integrity scrub
    scrubs: int = 0                 # per-entry scrub passes
    corruptions_injected: int = 0   # flip faults applied
    scrub_corruptions: int = 0      # entries caught with a CRC mismatch
    scrub_repairs: int = 0          # entries repaired bitwise from loaders


@dataclasses.dataclass
class ReplicaSet:
    """One arch group's replica pool. ``engines[r] is None`` = DEAD slot.
    ``snapshots[r]`` holds the last-seen incident counters of replica r's
    EngineStats (survives engine replacement: a fresh replica starts a
    fresh snapshot)."""
    group: str
    engines: list
    health: list
    snapshots: list

    def alive(self) -> list:
        return [r for r, e in enumerate(self.engines) if e is not None]


_INCIDENTS = (("recovery", "recoveries"), ("stall", "stalls"),
              ("quarantine", "errors"))


class ServingGateway:
    """Multi-model router over replicated per-group LLMEngines on
    ``device`` (``cuda`` unless the caller passes ``cpu``).

    ``engine_kw`` is forwarded to every engine the gateway builds — the
    shared admission/deadline policy (``admission``, ``max_waiting``,
    ``step_timeout_s``, ``packed``, ``capture``, ...). ``chunk_size`` is
    mandatory: multi-model steps serve prompts via chunk tasks, and a
    uniform step style keeps the pool's captures predictable (each engine
    captures the step shapes of one chunked engine). ``faults`` maps a
    model name to a :class:`~repro_torch.runtime.faults.FaultPlan`: its
    nan/fail/delay faults wire into replica 0 of that model's group only
    (chaos in one replica cannot reach another model's pool sibling, and
    survivors stay clean for failover); its ``flip`` faults are applied by
    the GATEWAY at its own step counter, corrupting the registry's
    resident alpha bank (a copy: engines keep their tensors) so the scrub
    has something real to catch.

    ``replicas`` sets the per-group replica count, ``health`` the
    incident thresholds (:class:`HealthPolicy`), and ``scrub_every`` the
    integrity-scrub cadence in gateway steps (0 = off)."""

    def __init__(self, registry: ModelRegistry, *, batch_slots: int = 4,
                 buffer_len: int = 128, chunk_size: int = 16,
                 eos_id: Optional[int] = None, device="cuda",
                 faults: Optional[dict] = None, replicas: int = 1,
                 health: Optional[HealthPolicy] = None,
                 scrub_every: int = 0, journal=None, **engine_kw):
        if chunk_size is None:
            raise ValueError("the gateway serves prompts via chunked steps; "
                             "chunk_size must be set")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.registry = registry
        # ONE journal backs the whole pool: replica failover and group
        # rebuilds move requests between engines without re-journaling
        # (admissions are idempotent by rid), so durable state is
        # process-scoped, exactly what crash recovery replays.
        self.journal = journal
        self.device = resolve_device(device)
        self._engine_kw = dict(batch_slots=batch_slots,
                               buffer_len=buffer_len,
                               chunk_size=chunk_size, eos_id=eos_id,
                               device=self.device, journal=journal,
                               **engine_kw)
        self._faults = dict(faults or {})
        for n in self._faults:
            if self.registry.get(n) is None:
                raise KeyError(f"fault plan targets unregistered model {n!r}")
        self.replicas = replicas
        self.health_policy = health or HealthPolicy()
        self.scrub_every = scrub_every
        self._groups: dict = {}         # group signature -> ReplicaSet
        self._routes: dict = {}         # id(req) -> (group, replica idx)
        self._rr = 0                    # round-robin cursor over replicas
        self._step_idx = 0              # gateway step counter (flip faults,
                                        # scrub cadence)
        self._scrub_cursor = 0
        self._finished: list = []
        self.stats = GatewayStats()

    # -- engine lifecycle ---------------------------------------------------

    @staticmethod
    def _close(eng: LLMEngine) -> None:
        """Free an engine's device state: its cached dense W, and its core's
        caches, graphs and graph pools (a graph holds raw addresses of the
        params and caches it was captured over)."""
        kops.clear_weight_cache(eng.model_label)
        eng.core.close()

    def _drop_group(self, group: str) -> None:
        """Drop a group's whole replica set (eviction callback / rebuild).
        The caller guarantees no live requests (pins checked, or the set
        was drained first)."""
        rs = self._groups.pop(group, None)
        if rs is not None:
            for eng in rs.engines:
                if eng is not None:
                    self._close(eng)
            self.stats.engines_dropped += 1

    def _make_replica(self, group: str, r: int, *, with_faults: bool
                      ) -> LLMEngine:
        members = self.registry.group_members(group)
        entries = [self.registry.entries[n] for n in members]
        cfg = entries[0].cfg
        label = "+".join(members)
        if self.replicas > 1:
            label = f"{label}@r{r}"
        kw = dict(self._engine_kw)
        plans = [self._faults[n] for n in members if n in self._faults]
        if plans and with_faults:
            kw["faults"] = plans[0]
        if len(members) == 1:
            eng = LLMEngine(entries[0].params, cfg, model_label=label, **kw)
        else:
            vset = stack_variants(
                [(n, e.params) for n, e in zip(members, entries)], cfg)
            eng = LLMEngine(vset.params, cfg, variants=vset.M,
                            model_index=vset.index, model_label=label, **kw)
        self.stats.replicas_built += 1
        return eng

    def _build_group(self, group: str) -> None:
        entries = [self.registry.entries[n]
                   for n in self.registry.group_members(group)]
        # injected engine faults live on replica 0 ONLY: survivors must be
        # clean or failover would re-kill the adopted work
        engines = [self._make_replica(group, r, with_faults=(r == 0))
                   for r in range(self.replicas)]
        self._groups[group] = ReplicaSet(
            group=group, engines=engines,
            health=[ReplicaHealth(self.health_policy)
                    for _ in range(self.replicas)],
            snapshots=[{attr: 0 for _k, attr in _INCIDENTS}
                       for _ in range(self.replicas)])
        self.stats.engine_builds += 1
        if any(e.evictions for e in entries):
            self.stats.reloads += 1

    def _ensure_group(self, group: str) -> bool:
        """Engines-for-group invariant: a replica set exists exactly when
        its group is resident (``_drop_group`` rides the eviction
        callback)."""
        if group in self._groups:
            return True
        if not self.registry.ensure_resident_group(
                group, on_evict=self._drop_group):
            return False
        self._build_group(group)
        return True

    # -- request intake -----------------------------------------------------

    def _pick_replica(self, rs: ReplicaSet) -> int:
        """Least-loaded alive replica; HEALTHY beats DEGRADED; ties go to
        the lowest index — fully deterministic, so two identical runs
        route identically (the stream-identity tests depend on it)."""
        alive = rs.alive()
        return min(alive, key=lambda r: (
            0 if rs.health[r].state == HEALTHY else 1,
            rs.engines[r]._remaining(), r))

    def add_request(self, req: Request) -> tuple:
        """Route ``req.model``; returns ``(admitted, info)`` where info is
        the engine backpressure float, or :data:`FINISH_EVICTED` when the
        model could not be made resident. Unknown models raise ``KeyError``
        (the HTTP layer's 404)."""
        self.stats.requests += 1
        entry = self.registry.get(req.model)
        if entry is None:
            self.stats.not_found += 1
            raise KeyError(f"unknown model {req.model!r}; registered: "
                           f"{sorted(self.registry.names())}")
        if not self._ensure_group(entry.group):
            self.stats.evicted_refusals += 1
            req.finish_reason = FINISH_EVICTED
            out = req.output()
            self._finished.append(out)
            if req.on_finish is not None and not req._notified:
                req._notified = True
                req.on_finish(out)
            return False, FINISH_EVICTED
        name = req.model
        self.registry.touch(name)
        self.registry.pin(name)        # in-flight requests block eviction
        prev = req.on_finish
        key = id(req)

        def _fin(out, _n=name, _prev=prev, _k=key):
            self.registry.unpin(_n)
            self._routes.pop(_k, None)
            self._finished.append(out)
            if _prev is not None:
                _prev(out)

        req.on_finish = _fin
        self.stats.routed[name] = self.stats.routed.get(name, 0) + 1
        rs = self._groups[entry.group]
        r = self._pick_replica(rs)
        self._routes[key] = (entry.group, r)
        return rs.engines[r].add_request(req)

    def cancel(self, req: Request) -> bool:
        """Cancel one in-flight request wherever it is routed (slot or
        queue): its slot and KV pages free immediately and ``on_finish``
        fires with FINISH_CANCELLED. False when already finished."""
        route = self._routes.get(id(req))
        if route is None:
            return False
        group, r = route
        rs = self._groups.get(group)
        if rs is None:
            return False
        eng = rs.engines[r]
        if eng is not None and eng.cancel(req):
            self.stats.cancelled += 1
            return True
        return False

    # -- crash recovery ------------------------------------------------------

    def recover_from_journal(self, *, wire=None) -> list:
        """Replay the write-ahead journal into the live pool: every
        non-terminal journaled request is rebuilt mid-stream (prompt
        rewrite + re-derived PRNG key — the preempt-and-recompute shape)
        and re-routed through :meth:`add_request`, so recovered streams
        resume token-identically past the journaled high-water mark.
        Requests whose deadline expired while the process was down finish
        as ``FINISH_TIMEOUT`` here — never silently resumed. ``wire(req)``
        attaches client callbacks before routing. Returns the re-admitted
        requests; the journal compacts afterwards."""
        j = self.journal
        if j is None:
            return []
        recovered = []
        for entry in j.live_entries():
            req = entry.to_request()
            if wire is not None:
                wire(req)
            if req.expired:
                req.finish_reason = FINISH_TIMEOUT
                j.finish(req.rid, FINISH_TIMEOUT)
                out = req.output()
                self._finished.append(out)
                if req.on_finish is not None and not req._notified:
                    req._notified = True
                    req.on_finish(out)
                continue
            try:
                self.add_request(req)
                recovered.append(req)
            except KeyError:
                # the journaled model is no longer registered (config
                # change across the restart): surface eviction-style
                # backpressure rather than stranding the client
                req.finish_reason = FINISH_EVICTED
                j.finish(req.rid, FINISH_EVICTED)
                out = req.output()
                self._finished.append(out)
                if req.on_finish is not None and not req._notified:
                    req._notified = True
                    req.on_finish(out)
        j.compact()
        return recovered

    # -- the step loop ------------------------------------------------------

    @property
    def pending(self) -> int:
        """Occupied slots + queued waiters across the pool."""
        return sum(e._remaining() for rs in self._groups.values()
                   for e in rs.engines if e is not None)

    def step(self) -> int:
        """One gateway iteration: apply scheduled ``flip`` faults, run the
        scrub cadence, then advance every alive replica one scheduler
        iteration (round-robin order rotating across calls so no replica
        systematically steps last), health-checking each replica as it
        goes. Returns the remaining work across the pool."""
        idx = self._step_idx
        self._step_idx += 1
        self._apply_flips(idx)
        if self.scrub_every and (idx + 1) % self.scrub_every == 0:
            self._scrub_tick()
        pairs = [(g, r) for g, rs in self._groups.items()
                 for r in range(len(rs.engines))]
        if not pairs:
            return 0
        n = len(pairs)
        for k in range(n):
            g, r = pairs[(self._rr + k) % n]
            rs = self._groups.get(g)
            if rs is None or r >= len(rs.engines):
                continue                # group rebuilt/removed mid-iteration
            eng = rs.engines[r]
            if eng is None:
                continue                # already failed over this iteration
            eng.step()
            self._health_tick(g, r)
        self._rr = (self._rr + 1) % n
        return self.pending

    def run_until_drained(self, max_steps: int = 10_000) -> GatewayStats:
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return self.stats

    # -- replica health + failover ------------------------------------------

    def _health_tick(self, group: str, r: int) -> None:
        """Book replica ``r``'s new incidents (EngineStats deltas since the
        last tick) into its health state machine; a DEAD verdict triggers
        failover immediately — in-flight work never waits on a dead
        replica."""
        rs = self._groups[group]
        eng = rs.engines[r]
        if eng is None:
            return
        snap = rs.snapshots[r]
        h = rs.health[r]
        clean = True
        for kind, attr in _INCIDENTS:
            cur = getattr(eng.stats, attr)
            d = cur - snap[attr]
            if d > 0:
                h.record(kind, d)
                clean = False
            snap[attr] = cur
        if clean:
            h.ok_step()
        if h.state == DEAD:
            self._failover(group, r)

    def _failover(self, group: str, r: int) -> None:
        """Drain DEAD replica ``r`` and re-route its in-flight requests to
        surviving replicas via the recompute path (token-identical resume).
        The last replica of a group gets a fresh replacement instead —
        losing every replica must not strand admitted work."""
        rs = self._groups[group]
        eng = rs.engines[r]
        rs.engines[r] = None
        self.stats.replicas_dead += 1
        self.stats.failovers += 1
        reqs = eng.drain_requests()
        self._close(eng)
        if not rs.alive():
            # replacement replica: clean (no fault plan — the plan died
            # with the replica) and health-fresh
            rs.engines[r] = self._make_replica(group, r, with_faults=False)
            rs.health[r] = ReplicaHealth(self.health_policy)
            rs.snapshots[r] = {attr: 0 for _k, attr in _INCIDENTS}
        for req in reqs:
            t = self._pick_replica(rs)
            self._routes[id(req)] = (group, t)
            rs.engines[t].adopt(req)
            self.stats.failover_requests += 1

    def _drain_group(self, group: str) -> list:
        """Strip every in-flight request off a group's replicas (rebuild /
        hot add/remove / scrub repair), preserving priority-FCFS order per
        replica."""
        rs = self._groups.get(group)
        if rs is None:
            return []
        out: list = []
        for eng in rs.engines:
            if eng is not None:
                out.extend(eng.drain_requests())
        return out

    def _resubmit(self, req: Request) -> None:
        """Re-adopt a drained request after its group was rebuilt."""
        entry = self.registry.get(req.model)
        if entry is None or not self._ensure_group(entry.group):
            # the model vanished mid-drain (hot remove of a sibling should
            # never strand work; treat like eviction backpressure)
            req.finish_reason = FINISH_EVICTED
            self.stats.evicted_refusals += 1
            out = req.output()
            if req.on_finish is not None and not req._notified:
                req._notified = True
                req.on_finish(out)
            return
        rs = self._groups[entry.group]
        t = self._pick_replica(rs)
        self._routes[id(req)] = (entry.group, t)
        rs.engines[t].adopt(req)

    # -- integrity scrub + flip faults --------------------------------------

    def _apply_flips(self, idx: int) -> None:
        """Fire scheduled ``flip`` faults: corrupt the target model's
        RESIDENT registry bank (the scrub's ground-truth copy). Engines
        hold their own stacked pytrees, so live streams keep serving
        clean weights while the scrub detects and repairs the bank —
        exactly the silent-corruption scenario a background scrub exists
        for."""
        for name, plan in self._faults.items():
            for f in plan.at(idx):
                if f.kind != "flip":
                    continue
                e = self.registry.get(name)
                if e is not None and e.resident:
                    self.registry.corrupt(name, leaf=f.leaf, bit=f.bit)
                    self.stats.corruptions_injected += 1

    def _scrub_tick(self) -> None:
        """Scrub ONE resident group (round-robin across ticks — constant
        per-step cost regardless of pool size). On any CRC mismatch the
        whole group is repaired: drain, bitwise re-residency from loaders
        (verified against the ledger), engine rebuild, recompute resume."""
        groups = [g for g, rs in self._groups.items() if rs.alive()]
        if not groups:
            return
        g = groups[self._scrub_cursor % len(groups)]
        self._scrub_cursor += 1
        bad = 0
        for n in self.registry.group_members(g):
            self.stats.scrubs += 1
            if self.registry.scrub(n):
                bad += 1
        if not bad:
            return
        self.stats.scrub_corruptions += bad
        migrated = self._drain_group(g)
        self._drop_group(g)
        self.registry.repair_group(g)
        self.stats.scrub_repairs += bad
        self._build_group(g)
        for req in migrated:
            self._resubmit(req)

    # -- hot model add / remove ---------------------------------------------

    def add_model(self, name: str, cfg, loader: Callable[[], Any],
                  tags: tuple = ()):
        """Hot ADD: register + make resident on the live pool. A
        same-architecture group gains a stacked variant (its engines
        rebuild; in-flight work resumes via recompute). Raises
        ``ValueError`` on a duplicate name and :class:`BudgetExceeded` —
        with the registration rolled back — when the byte budget cannot
        admit the group."""
        entry = self.registry.register(name, cfg, loader, tags=tags)
        group = entry.group
        migrated = []
        had_engines = group in self._groups
        if had_engines:
            # engines restack with the new member on rebuild; residency of
            # the existing members is untouched
            migrated = self._drain_group(group)
            self._drop_group(group)
        if not self.registry.ensure_resident_group(
                group, on_evict=self._drop_group):
            self.registry.unregister(name)
            if migrated:                # restore the pre-add group
                self.registry.ensure_resident_group(
                    group, on_evict=self._drop_group)
                for req in migrated:
                    self._resubmit(req)
            raise BudgetExceeded(
                f"model {name!r} cannot be made resident within the byte "
                "budget")
        for req in migrated:
            self._resubmit(req)
        return entry

    def remove_model(self, name: str):
        """Hot REMOVE: unregister + drop from the live pool. Raises
        ``KeyError`` for unknown names and :class:`ModelInFlight` while
        requests are live. Sibling variants' in-flight work migrates to
        the restacked group."""
        entry = self.registry.entries[name]     # KeyError -> HTTP 404
        if entry.pinned:
            raise ModelInFlight(
                f"model {name!r} has {entry.pinned} in-flight request(s); "
                "drain first")
        group = entry.group
        migrated = []
        if group in self._groups:
            migrated = self._drain_group(group)
            self._drop_group(group)
        self.registry.unregister(name)
        for req in migrated:       # siblings rebuild without the member
            self._resubmit(req)
        return entry

    # -- introspection ------------------------------------------------------

    def outputs(self) -> list:
        """Finished requests across the pool, in gateway finish order."""
        return list(self._finished)

    def resident_bytes(self) -> int:
        """ACTUAL resident params footprint: the sum over groups of their
        (stacked) pytree bytes — replicas share the same resident alpha
        bank (the paper's premise is what makes replication cheap), so a
        group is charged once regardless of replica count."""
        total = 0
        for rs in self._groups.values():
            alive = rs.alive()
            if alive:
                total += param_bytes(rs.engines[alive[0]].params)
        return total

    def engine_for(self, name: str) -> Optional[LLMEngine]:
        """First alive replica of the model's group (primary)."""
        entry = self.registry.get(name)
        if entry is None:
            return None
        rs = self._groups.get(entry.group)
        if rs is None:
            return None
        alive = rs.alive()
        return rs.engines[alive[0]] if alive else None

    def health_of(self, name: str) -> list:
        """Replica health states of the model's group (``[]`` = no
        engines)."""
        entry = self.registry.get(name)
        if entry is None or entry.group not in self._groups:
            return []
        rs = self._groups[entry.group]
        return [rs.health[r].state if rs.engines[r] is not None else DEAD
                for r in range(len(rs.engines))]


# ---------------------------------------------------------------------------
# The async HTTP front door (stdlib asyncio only — no new dependencies)
# ---------------------------------------------------------------------------

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            409: "Conflict", 500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable"}


class _BadRequest(ValueError):
    """Client error in a /v1/completions body (mapped to HTTP 400)."""

    def __init__(self, message: str, param: Optional[str] = None):
        super().__init__(message)
        self.param = param


def _vet_int(spec: dict, key: str, default: int, minimum: int) -> int:
    v = spec.get(key, default)
    if isinstance(v, bool) or not isinstance(v, int):
        raise _BadRequest(f"{key!r} must be an integer", param=key)
    if v < minimum:
        raise _BadRequest(f"{key!r} must be >= {minimum}", param=key)
    return v


def _vet_num(spec: dict, key: str, default: float) -> float:
    v = spec.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _BadRequest(f"{key!r} must be a number", param=key)
    return float(v)


class GatewayHTTPServer:
    """Minimal OpenAI-compatible HTTP server over a :class:`ServingGateway`.

    Routes:
      ``GET /v1/models``           registered models + residency
      ``POST /v1/completions``     token-id completions; ``"stream": true``
                                   emits SSE chunks (one per committed token)
      ``POST /admin/models``       hot ADD (requires ``model_factory``)
      ``DELETE /admin/models/<id>``hot REMOVE (409 while in flight)
      ``POST /admin/drain``        graceful drain: stop admission, finish
                                   live work, then ``drained`` is set
      ``GET /admin/health``        replica states, breaker states, scrub +
                                   failover counters

    There is no tokenizer in this repo: ``prompt`` is a list of token ids
    (a string prompt is mapped deterministically onto ids via char codes
    modulo the model's vocab). The engine pump runs in ONE background
    thread, the only one that touches the device (module docstring):
    intake (``add_request``), cancellation, hot add/remove and journal
    recovery are calls the handlers hand to the pump (``_on_pump``), which
    runs them between steps; token/finish callbacks hop back into the
    event loop via ``call_soon_threadsafe``. ``self._lock`` guards the
    gateway's host state that handlers read while the pump steps.

    ``breaker_after > 0`` arms a per-model :class:`CircuitBreaker`:
    ``breaker_after`` consecutive FINISH_ERROR completions trip the model
    to 503 + ``Retry-After`` for ``breaker_cooldown_s``; then one probe
    request is admitted — success re-closes, failure re-opens.

    ``model_factory(spec)`` (from the launcher) maps a ``POST
    /admin/models`` JSON body to ``(name, cfg, loader, tags)``; without
    one the route answers 501.

    Durability & exactly-once (when the gateway carries a
    ``serving.journal.RequestJournal``):

    * a client-supplied **idempotency key** (``Idempotency-Key`` header or
      ``idempotency_key`` body field) dedupes retries: a key already
      executing attaches the new connection to the ONE in-flight request;
      a key already finished replays the durable result; a key reused
      with a *different* body gets 409 ``idempotency_conflict``. The map
      survives crashes — it is rebuilt from the journal on startup.
    * SSE chunks carry ``id: <token index>`` fields; a reconnecting client
      sends ``Last-Event-ID`` and receives only the tokens past it (the
      journaled prefix replays instantly, then the stream continues live).
    * :meth:`recover` replays the journal into the pool on startup:
      non-terminal requests resume token-identically mid-stream, expired
      ones finish FINISH_TIMEOUT, and new rids start past the journaled
      high-water mark so rid-keyed state never collides."""

    def __init__(self, gateway: ServingGateway, host: str = "127.0.0.1",
                 port: int = 8080, *, breaker_after: int = 0,
                 breaker_cooldown_s: float = 2.0, breaker_probes: int = 1,
                 retry_after_s: int = 1,
                 model_factory: Optional[Callable[[dict], tuple]] = None):
        self.gateway = gateway
        self.host = host
        self.port = port
        self.breaker_after = breaker_after
        self.breaker_cooldown_s = breaker_cooldown_s
        self.breaker_probes = breaker_probes
        self.retry_after_s = max(1, int(retry_after_s))
        self.model_factory = model_factory
        self._breakers: dict = {}       # model name -> CircuitBreaker
        self.breaker_rejections = 0
        self.draining = False
        self.drained: Optional[asyncio.Event] = None
        self._lock = threading.Lock()
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._stop = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._rids = itertools.count()
        # Exactly-once client state (loop-thread only): per-rid token
        # records fan tokens out to every attached connection, and the
        # idempotency map points retried keys at the one execution. Both
        # are rebuilt from the journal after a crash.
        self._records: dict = {}        # rid -> {tokens, out, queues}
        self._ikeys: dict = {}          # key -> {fp, rid, state, result}

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self.loop = asyncio.get_running_loop()
        self.drained = asyncio.Event()
        self._restore_idempotency()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # resolve :0
        self._pump_thread = threading.Thread(target=self._pump, daemon=True)
        self._pump_thread.start()

    async def stop(self) -> None:
        self._stop.set()
        if self._pump_thread is not None:
            await self.loop.run_in_executor(None, self._pump_thread.join)
        self._run_inbox(refuse=True)    # calls the pump did not take
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    def _pump(self) -> None:
        """Background step loop, the one thread that touches the device:
        runs the calls the handlers queued, then steps the pool whenever
        any engine has work; idles on a short wait otherwise. Completes the
        graceful drain: once draining is requested and the pool is empty,
        the ``drained`` event fires (the launcher exits 0 on it); the pump
        keeps taking calls until ``stop``."""
        fired = False
        while not self._stop.is_set():
            self._run_inbox()
            with self._lock:
                pending = self.gateway.pending
                work = self.gateway.step() if pending else 0
            if self.draining and not work and not pending and not fired:
                fired = True
                self.loop.call_soon_threadsafe(self.drained.set)
            if not work:
                self._stop.wait(0.002)

    def _run_inbox(self, refuse: bool = False) -> None:
        """Run the queued handler calls (on the pump thread) and hand each
        result or exception to its future on the event loop; ``refuse``
        fails them instead (the pump has stopped)."""
        while True:
            try:
                fn, fut = self._inbox.get_nowait()
            except queue.Empty:
                return
            if refuse:
                ok, val = False, RuntimeError("the gateway pump has stopped")
            else:
                try:
                    with self._lock:
                        ok, val = True, fn()
                except Exception as exc:    # noqa: BLE001 — to the handler
                    ok, val = False, exc
            self.loop.call_soon_threadsafe(self._settle, fut, ok, val)

    @staticmethod
    def _settle(fut: asyncio.Future, ok: bool, val) -> None:
        if fut.done():
            return
        if ok:
            fut.set_result(val)
        else:
            fut.set_exception(val)

    async def _on_pump(self, fn):
        """Run ``fn()`` on the pump thread between steps; its result (or
        its exception, raised here)."""
        fut = self.loop.create_future()
        self._inbox.put((fn, fut))
        return await fut

    # -- durability: journal restore + token fan-out -------------------------

    def _restore_idempotency(self) -> None:
        """Rebuild the idempotency map from the journal (crash restart):
        finished entries replay their durable result to retrying clients;
        live entries attach retries to the recovered execution. New rids
        start past the journaled high-water mark."""
        j = getattr(self.gateway, "journal", None)
        if j is None:
            return
        for e in j.entries.values():
            if not e.done:
                # seed the journaled prefix BEFORE the socket binds, so a
                # retry that attaches in the start()->recover() window
                # still replays a continuous stream
                self._record(e.rid)["tokens"] = list(e.tokens)
            if not e.ikey:
                continue
            res = None
            if e.done:
                res = {"tokens": list(e.tokens),
                       "finish_reason": e.finish_reason,
                       "prompt_len": len(e.prompt)}
            self._ikeys[e.ikey] = {"fp": e.fp, "rid": e.rid,
                                   "state": "done" if e.done else "live",
                                   "result": res}
        self._rids = itertools.count(j.max_rid + 1)

    async def recover(self) -> int:
        """Crash recovery: replay the journal into the pool. Each rebuilt
        request is wired into the server's token records before routing,
        so SSE reconnects (``Last-Event-ID``) and idempotent retries see
        one continuous stream spanning the crash. The replay (which builds
        engines) runs on the pump thread. Returns the number of re-admitted
        requests."""
        loop = self.loop

        def wire(req):
            rid = req.rid
            rec = self._record(rid)
            rec["tokens"] = list(req.out_tokens)    # journaled prefix
            model, ikey = req.model, req.idempotency_key

            def on_tok(_r, tok, _rid=rid):
                loop.call_soon_threadsafe(self._push_tok, _rid, int(tok))

            def on_fin(out, _rid=rid, _m=model, _k=ikey):
                loop.call_soon_threadsafe(self._push_fin, _rid, _m, _k, out)

            req.stream = on_tok
            req.on_finish = on_fin

        return len(await self._on_pump(
            lambda: self.gateway.recover_from_journal(wire=wire)))

    def _record(self, rid: int) -> dict:
        rec = self._records.get(rid)
        if rec is None:
            rec = {"tokens": [], "out": None, "queues": []}
            self._records[rid] = rec
        return rec

    def _push_tok(self, rid: int, tok: int) -> None:
        """Commit one token to the rid's record and fan it out to every
        attached connection (loop thread only — no locking needed)."""
        rec = self._record(rid)
        idx = len(rec["tokens"])
        rec["tokens"].append(tok)
        for q in rec["queues"]:
            q.put_nowait(("tok", idx, tok))

    def _push_fin(self, rid: int, model: Optional[str],
                  ikey: Optional[str], out) -> None:
        self._note_finish(model, out)
        rec = self._record(rid)
        rec["out"] = out
        for q in rec["queues"]:
            q.put_nowait(("fin", out))
        rec["queues"] = []
        if ikey is not None and ikey in self._ikeys:
            self._ikeys[ikey].update(
                state="done",
                result={"tokens": list(out.tokens),
                        "finish_reason": out.finish_reason,
                        "prompt_len": out.prompt_len})

    # -- per-model circuit breakers -----------------------------------------

    def _breaker(self, model: str) -> Optional[CircuitBreaker]:
        if self.breaker_after <= 0 or model is None:
            return None
        br = self._breakers.get(model)
        if br is None:
            br = CircuitBreaker(trip_after=self.breaker_after,
                                cooldown_s=self.breaker_cooldown_s,
                                probes=self.breaker_probes)
            self._breakers[model] = br
        return br

    def _note_finish(self, model: str, out) -> None:
        """Feed a completion's terminal reason to the model's breaker
        (runs on the event loop — breakers are not thread-safe)."""
        br = self._breaker(model)
        if br is None:
            return
        if out.finish_reason == "error":
            br.record_failure()
        elif out.finish_reason in ("eos", "length"):
            br.record_success()

    # -- HTTP plumbing ------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", "0") or 0)
            if n:
                body = await reader.readexactly(n)
            if method == "GET" and path == "/v1/models":
                await self._models(writer)
            elif method == "POST" and path == "/v1/completions":
                await self._completions(writer, body, headers)
            elif method == "POST" and path == "/admin/models":
                await self._admin_add(writer, body)
            elif method == "DELETE" and path.startswith("/admin/models/"):
                await self._admin_remove(writer,
                                         path[len("/admin/models/"):])
            elif method == "POST" and path == "/admin/drain":
                await self._admin_drain(writer)
            elif method == "GET" and path == "/admin/health":
                await self._admin_health(writer)
            else:
                await self._error(writer, 404, f"no route {method} {path}",
                                  code="not_found")
        except Exception as exc:            # noqa: BLE001 — server must live
            try:
                await self._error(writer, 500, f"{type(exc).__name__}: {exc}",
                                  code="internal_error")
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _json(self, writer, status: int, obj,
                    headers: Optional[dict] = None) -> None:
        data = json.dumps(obj).encode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write((f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
                      "Content-Type: application/json\r\n"
                      f"Content-Length: {len(data)}\r\n"
                      f"{extra}"
                      "Connection: close\r\n\r\n").encode() + data)
        await writer.drain()

    async def _error(self, writer, status: int, message: str,
                     code: str = "error", param: Optional[str] = None,
                     retry_after: Optional[int] = None) -> None:
        # OpenAI-style error object; every 503 carries Retry-After so
        # clients can back off instead of hammering a cold/broken model
        err = {"message": message, "type": code, "code": code}
        if param is not None:
            err["param"] = param
        headers = None
        if status == 503:
            headers = {"Retry-After": str(retry_after
                                          if retry_after is not None
                                          else self.retry_after_s)}
        await self._json(writer, status, {"error": err}, headers=headers)

    # -- routes -------------------------------------------------------------

    async def _models(self, writer) -> None:
        data = [{"id": n, "object": "model", "owned_by": "repro_torch",
                 "ready": self.gateway.registry.entries[n].resident,
                 "tags": list(self.gateway.registry.entries[n].tags)}
                for n in self.gateway.registry.names()]
        await self._json(writer, 200, {"object": "list", "data": data})

    def _parse_completion(self, spec: dict, entry) -> dict:
        """Validate a completions body; raises :class:`_BadRequest` with
        the offending param (the 400 path — client bugs must not surface
        as 500s)."""
        prompt = spec.get("prompt", [])
        if isinstance(prompt, str):
            prompt = [ord(c) % entry.cfg.vocab for c in prompt]
        elif isinstance(prompt, list):
            if not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt):
                raise _BadRequest("'prompt' list must contain token ids "
                                  "(integers)", param="prompt")
        else:
            raise _BadRequest("'prompt' must be a string or a list of "
                              "token ids", param="prompt")
        if not prompt:
            prompt = [1]
        stream = spec.get("stream", False)
        if not isinstance(stream, bool):
            raise _BadRequest("'stream' must be a boolean", param="stream")
        deadline = spec.get("deadline_s")
        if deadline is not None and (isinstance(deadline, bool)
                                     or not isinstance(deadline, (int, float))
                                     or deadline <= 0):
            raise _BadRequest("'deadline_s' must be a positive number",
                              param="deadline_s")
        return dict(
            prompt=prompt, stream=stream, deadline_s=deadline,
            max_tokens=_vet_int(spec, "max_tokens", 16, 1),
            temperature=_vet_num(spec, "temperature", 0.0),
            top_k=_vet_int(spec, "top_k", 0, 0),
            seed=_vet_int(spec, "seed", 0, -(2 ** 63)))

    @staticmethod
    def _completion_payload(rid: int, model: Optional[str], out) -> dict:
        return {"id": f"cmpl-{rid}", "object": "text_completion",
                "model": model,
                "choices": [{"index": 0,
                             "text": " ".join(str(t) for t in out.tokens),
                             "token_ids": list(out.tokens),
                             "finish_reason": out.finish_reason}],
                "usage": {"prompt_tokens": out.prompt_len,
                          "completion_tokens": out.n_tokens,
                          "total_tokens": out.prompt_len + out.n_tokens}}

    async def _completions(self, writer, body: bytes,
                           headers: Optional[dict] = None) -> None:
        headers = headers or {}
        if self.draining:
            return await self._error(
                writer, 503, "gateway is draining; no new admissions",
                code="draining")
        try:
            spec = json.loads(body or b"{}")
            if not isinstance(spec, dict):
                raise _BadRequest("request body must be a JSON object")
        except json.JSONDecodeError as exc:
            return await self._error(writer, 400, f"bad JSON body: {exc}",
                                     code="invalid_request_error")
        except _BadRequest as exc:
            return await self._error(writer, 400, str(exc),
                                     code="invalid_request_error")
        model = spec.get("model")
        entry = self.gateway.registry.get(model)
        if entry is None:
            return await self._error(
                writer, 404, f"model {model!r} not found",
                code="model_not_found")
        br = self._breaker(model)
        if br is not None and not br.allow():
            self.breaker_rejections += 1
            return await self._error(
                writer, 503,
                f"model {model!r} is failing (circuit breaker open); "
                "retry later", code="breaker_open",
                retry_after=br.retry_after_s())
        try:
            fields = self._parse_completion(spec, entry)
        except _BadRequest as exc:
            return await self._error(writer, 400, str(exc),
                                     code="invalid_request_error",
                                     param=exc.param)
        stream = fields["stream"]
        # SSE resume: a reconnecting client names the last event id it saw
        # (== absolute token index); only tokens past it are (re)sent
        try:
            last = int(headers.get("last-event-id", -1))
        except (TypeError, ValueError):
            last = -1
        # Exactly-once: dedupe by idempotency key against the (journal-
        # durable) map — same body attaches/replays, different body 409s
        ikey = spec.get("idempotency_key", headers.get("idempotency-key"))
        if ikey is not None and (not isinstance(ikey, str) or not ikey):
            return await self._error(
                writer, 400, "'idempotency_key' must be a non-empty string",
                code="invalid_request_error", param="idempotency_key")
        fp = body_fingerprint(fields["prompt"], fields["max_tokens"],
                              fields["temperature"], fields["top_k"],
                              fields["seed"], model)
        if ikey is not None:
            known = self._ikeys.get(ikey)
            if known is not None and known.get("rid") is None:
                self._ikeys.pop(ikey, None)     # stale: intake never ran
                known = None
            if known is not None:
                if known["fp"] != fp:
                    return await self._error(
                        writer, 409,
                        f"idempotency key {ikey!r} was already used with a "
                        "different request body", code="idempotency_conflict")
                return await self._attach(writer, known, model, stream, last)
            self._ikeys[ikey] = {"fp": fp, "rid": None, "state": "live",
                                 "result": None}
        rid = next(self._rids)
        if ikey is not None:
            self._ikeys[ikey]["rid"] = rid
        rec = self._record(rid)
        q: asyncio.Queue = asyncio.Queue()
        rec["queues"].append(q)
        loop = self.loop

        def on_tok(_rid, tok, _r=rid):
            loop.call_soon_threadsafe(self._push_tok, _r, int(tok))

        def on_fin(out, _r=rid, _m=model, _k=ikey):
            loop.call_soon_threadsafe(self._push_fin, _r, _m, _k, out)

        req = Request(
            rid, np.asarray(fields["prompt"], np.int32),
            max_new_tokens=fields["max_tokens"],
            model=model,
            sampling=SamplingParams(
                temperature=fields["temperature"],
                top_k=fields["top_k"],
                seed=fields["seed"]),
            deadline_s=fields["deadline_s"],
            idempotency_key=ikey,
            stream=on_tok,
            on_finish=on_fin)

        try:
            # intake may load a group and build its engines: the pump runs
            # it, and concurrent requests still parse meanwhile
            _admitted, info = await self._on_pump(
                lambda: self.gateway.add_request(req))
        except KeyError as exc:
            self._ikeys.pop(ikey, None)     # nothing executed: retryable
            return await self._error(writer, 404, str(exc),
                                     code="model_not_found")
        if info == FINISH_EVICTED:
            self._ikeys.pop(ikey, None)     # backpressure, not a result:
            return await self._error(       # a later retry should execute
                writer, 503,
                f"model {model!r} is evicted and cannot be made resident "
                "within the byte budget; retry later",
                code="model_evicted")
        # Any other refusal (rejected/shed) already finalized the request:
        # the "fin" event is queued and the loops below return immediately.
        if stream:
            return await self._stream_sse(writer, q, rid, model, req)
        out = None
        while out is None:
            item = await q.get()
            if item[0] == "fin":
                out = item[1]
        await self._json(writer, 200,
                         self._completion_payload(rid, model, out))

    async def _attach(self, writer, known: dict, model: Optional[str],
                      stream: bool, last: int) -> None:
        """Serve a retried idempotency key from the ONE execution: replay
        the durable result when it already finished, otherwise attach this
        connection to the live request's token record (tokens past
        ``last`` replay first, then the stream continues live)."""
        rid = known["rid"]
        if known["state"] == "done":
            res = known["result"]
            out = RequestOutput(rid=rid, prompt_len=res["prompt_len"],
                                tokens=tuple(res["tokens"]),
                                finish_reason=res["finish_reason"])
            if not stream:
                return await self._json(
                    writer, 200, self._completion_payload(rid, model, out))
            q: asyncio.Queue = asyncio.Queue()
            for i, t in enumerate(out.tokens):
                if i > last:
                    q.put_nowait(("tok", i, int(t)))
            q.put_nowait(("fin", out))
            return await self._stream_sse(writer, q, rid, model, None)
        rec = self._record(rid)
        q = asyncio.Queue()
        for i, t in enumerate(rec["tokens"]):
            if i > last:
                q.put_nowait(("tok", i, int(t)))
        rec["queues"].append(q)
        if stream:
            # req=None: an attached retry must not cancel the shared
            # execution when ITS connection drops — others may be watching
            return await self._stream_sse(writer, q, rid, model, None)
        out = None
        while out is None:
            item = await q.get()
            if item[0] == "fin":
                out = item[1]
        await self._json(writer, 200,
                         self._completion_payload(rid, model, out))

    async def _stream_sse(self, writer, q: asyncio.Queue, rid: int,
                          model: str, req: Optional[Request]) -> None:
        """SSE streaming with disconnect-cancellation: when the client
        goes away mid-stream, the underlying request is cancelled —
        releasing its slot and KV pages for live traffic — instead of
        burning the rest of its token budget into a dead socket.
        ``req=None`` marks an attached/replayed connection (idempotent
        retry, Last-Event-ID resume): its disconnect detaches the queue
        but never cancels the shared execution.

        Every token chunk carries an SSE ``id:`` field — the absolute
        token index in the stream — so a client that reconnects after a
        gateway crash sends ``Last-Event-ID`` and resumes exactly past
        the last token it saw."""
        rec = self._records.get(rid)
        try:
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()
            while True:
                item = await q.get()
                if writer.is_closing():
                    raise ConnectionResetError("SSE client went away")
                if item[0] == "tok":
                    _kind, idx, tok = item
                    chunk = {"id": f"cmpl-{rid}", "object": "text_completion",
                             "model": model,
                             "choices": [{"index": 0, "text": f"{tok} ",
                                          "token": tok,
                                          "finish_reason": None}]}
                    writer.write(b"id: " + str(idx).encode()
                                 + b"\ndata: " + json.dumps(chunk).encode()
                                 + b"\n\n")
                    await writer.drain()
                else:
                    out = item[1]
                    chunk = {"id": f"cmpl-{rid}", "object": "text_completion",
                             "model": model,
                             "choices": [{"index": 0, "text": "",
                                          "finish_reason":
                                          out.finish_reason}]}
                    writer.write(b"data: " + json.dumps(chunk).encode()
                                 + b"\n\ndata: [DONE]\n\n")
                    await writer.drain()
                    return
        except (ConnectionResetError, BrokenPipeError,
                ConnectionAbortedError):
            if req is None:
                return                  # attached retry: just detach below

            await self._on_pump(lambda: self.gateway.cancel(req))
        finally:
            if rec is not None and q in rec["queues"]:
                rec["queues"].remove(q)

    # -- admin routes -------------------------------------------------------

    async def _admin_add(self, writer, body: bytes) -> None:
        if self.model_factory is None:
            return await self._error(
                writer, 501, "hot model ADD needs a model_factory (the "
                "launcher provides one)", code="not_implemented")
        try:
            spec = json.loads(body or b"{}")
            if not isinstance(spec, dict):
                raise ValueError("body must be a JSON object")
        except (json.JSONDecodeError, ValueError) as exc:
            return await self._error(writer, 400, f"bad JSON body: {exc}",
                                     code="invalid_request_error")
        try:
            name, cfg, loader, tags = self.model_factory(spec)
        except (KeyError, ValueError) as exc:
            return await self._error(writer, 400, str(exc),
                                     code="invalid_request_error")

        try:
            entry = await self._on_pump(
                lambda: self.gateway.add_model(name, cfg, loader, tags=tags))
        except BudgetExceeded as exc:
            return await self._error(writer, 409, str(exc),
                                     code=BudgetExceeded.code)
        except ValueError as exc:       # duplicate registration
            return await self._error(writer, 409, str(exc),
                                     code="model_exists")
        await self._json(writer, 200, {
            "id": entry.name, "object": "model", "ready": entry.resident,
            "tags": list(entry.tags)})

    async def _admin_remove(self, writer, name: str) -> None:
        try:
            await self._on_pump(lambda: self.gateway.remove_model(name))
        except KeyError:
            return await self._error(writer, 404,
                                     f"model {name!r} not found",
                                     code="model_not_found")
        except ModelInFlight as exc:
            return await self._error(writer, 409, str(exc),
                                     code=ModelInFlight.code)
        await self._json(writer, 200, {"id": name, "deleted": True})

    async def _admin_drain(self, writer) -> None:
        """Graceful drain: stop admitting, let the pump finish live work,
        then fire ``drained`` (the launcher awaits it and exits 0)."""
        self.draining = True
        with self._lock:
            pending = self.gateway.pending
        if pending == 0:
            # pump may already be parked; don't make the caller wait on it
            self.drained.set()
        await self._json(writer, 200,
                         {"status": "draining", "pending": pending})

    async def _admin_health(self, writer) -> None:
        gw = self.gateway
        models = {}
        for n in gw.registry.names():
            models[n] = {
                "replicas": gw.health_of(n),
                "breaker": (self._breakers[n].state
                            if n in self._breakers else "closed"),
            }
        s = gw.stats
        await self._json(writer, 200, {
            "draining": self.draining,
            "models": models,
            "failovers": s.failovers,
            "failover_requests": s.failover_requests,
            "replicas_dead": s.replicas_dead,
            "scrubs": s.scrubs,
            "scrub_corruptions": s.scrub_corruptions,
            "scrub_repairs": s.scrub_repairs,
            "cancelled": s.cancelled,
        })
