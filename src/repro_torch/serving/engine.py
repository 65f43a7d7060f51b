"""LLMEngine: step-based serving (port of ``repro.serving.engine``).

Each ``step()``: expired deadlines finish, the
:class:`~repro_torch.serving.scheduler.FCFSScheduler` emits one
:class:`SchedulerOutput` (running decode slots plus fixed-size prompt
chunks, and under ``admission="preempt"`` a slot to evict; with
``chunk_size=None``, the legacy phase-based mode, running decode slots
plus whole prefill groups for the free slots, bucketed by length unless
``bucketed_prefill=False``), the evicted slot is requeued for recompute,
``_page_gate`` grants the KV pages the step needs when the cache is paged,
and the :class:`~repro_torch.serving.core.EngineCore` runs it in the
engine's style (contiguous or paged cache, window or packed step, or the
legacy prefill groups and decode) with fused sampling; this module tracks
slots, prefill progress, finish reasons, streaming callbacks and the
``EngineStats`` counters. ``scheduler=`` takes another scheduler: one with
``schedule``, or a legacy one with only ``add`` / ``next_group`` /
``__len__``, adapted by ``scheduler.legacy_schedule``.

When the model has OVSF layers and its config carries no plan, the engine
asks the layer mapper (``runtime.mapper``) for a decode-shaped
``ExecutionPlan``, as the reference engine does (``plan_cfg``). The target
follows the device: ``h100`` on the card, where ``fused`` is the one path
with a hand-written kernel and so the one candidate, and ``cpu`` with the
reference's default candidates on the CPU. With ``calibrate=True`` every
chunk-free step's wall time is attributed to the plan's entries
(``runtime.calibrate.update_from_step``, host arithmetic, no device sync)
into ``self.calibration``, keyed by ``self.hw_label``; ``replan()`` plans
again under that table with the engine's own target and candidates, and
returns the plan without swapping it in, as the reference does.

Failure handling, as the reference's:

* **Preemption and recompute.** A slot evicted for a more urgent waiter
  (``admission="preempt"``) or by a page-pool shortfall of running work
  (``_page_gate``: the least urgent, youngest scheduled slot goes first)
  releases its pages, its prompt becomes ``original + generated tokens``,
  and it goes back to the waiting queue in its arrival order; chunked
  prefill recomputes its context. Streams resume token for token, greedy
  and sampled (a draw is a pure function of the seed and the tokens
  emitted, ``serving.core``).
* **NaN quarantine.** A slot whose emitted logits are not finite finishes
  ``FINISH_ERROR``; the others keep serving.
* **Watchdog.** A step that raises, or takes longer than
  ``step_timeout_s`` (its output is committed first), requeues every live
  slot recompute-style and rebuilds the core: the old core's caches,
  graphs and graph pools are freed first, and the new core carries
  ``step_idx`` and ``step_shapes`` over and captures its graphs anew on
  its first step of each shape (a graph holds raw addresses of the old
  caches and is never replayed against new ones). The stall clock leaves
  out the first call of each shape on a core (warm-up and capture,
  ``StepGraphs.first_calls``; counted in ``EngineStats.warmups``): the
  reference's rebuilt core reuses its jit traces, the port's captures
  again, and a capture counted as a stall would rebuild the core again on
  its own first step, so a ``step_timeout_s`` below the capture time would
  never finish a prompt. Recovery needs a device
  that still answers: an error that poisons the CUDA context (a
  device-side trap, such as ``ovsf_decompress``'s out-of-range code id)
  makes every later call fail, so the engine re-raises it and the process
  must be restarted (``launch.serve --journal --supervise``).
* **Deadlines, shedding, cancellation.** ``Request.deadline_s`` expires
  queued and running requests as ``FINISH_TIMEOUT``; a bounded waiting
  queue (``max_waiting``) sheds the least urgent request as
  ``FINISH_SHED``; ``cancel()`` finishes a request as
  ``FINISH_CANCELLED`` and frees its slot and pages at once.
* **Durability.** With a ``journal`` (``serving.journal.RequestJournal``)
  admissions, tokens and finishes are logged, flushed once a step and on
  every finish; ``recover_from_journal()`` re-admits a crashed process's
  live requests through the recompute path.

``packed`` and ``paged`` need ``chunk_size``, as in the reference. The
recurrent families (``ssm``, ``hybrid``) are served by the legacy path
with exact per-request prefill only, as in the reference: given a
``chunk_size`` the engine warns and falls back to phase-based serving,
dropping ``packed`` and ``paged``, and ``bucketed`` is False (a padded
prefill would run their state through the padding). The encoder-decoder
and VLM families are served in every style from tokens alone, as the
reference serves them: ``Request`` carries no frames or image embeds, so
the cross caches stay zero and a VLM runs text only (``serving.core``).

Multi-model mode (the gateway's same-architecture batching,
``serving.gateway``): ``variants=M`` stacked alpha variants in the params
(``serving.model_registry.stack_variants``), ``model_index`` mapping a
``Request.model`` name to its variant row. Each admitted request's slot is
routed through ``EngineCore.model_ids``; the mapper is off (a stacked bank
runs ``kernels.ops.ovsf_matmul_multi`` whatever the plan says), and
``chunk_size`` is required. ``use_mapper=False`` serves an unplanned
config (``cfg.ovsf.exec_path``), as the reference's flag does: the
gateway's dedicated baselines pin ``spectral`` so that their streams can be
held bit for bit against the multi engine's. ``model_label`` (default the
config's name) keys this engine's ledger in the decompress-weight cache:
steps run inside ``kernels.ops.weight_cache_scope(model_label)`` and
``EngineStats.weight_cache_*`` are that ledger's counters since the
engine's construction.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.runtime import mapper
from repro_torch.runtime.calibrate import CalibrationTable, update_from_step
from repro_torch.runtime.faults import FaultPlan
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_EOS,
                                     FINISH_ERROR, FINISH_LENGTH,
                                     FINISH_PREEMPTED, FINISH_REJECTED,
                                     FINISH_SHED, FINISH_TIMEOUT, Request,
                                     RequestOutput, SamplingParams)
from repro_torch.serving.core import EngineCore, StepOutput
from repro_torch.serving.scheduler import (FCFSScheduler, SchedulerOutput,
                                           legacy_schedule, pack_bucket)

__all__ = ["LLMEngine", "EngineStats", "Request", "SamplingParams",
           "RequestOutput", "plan_cfg"]

# device type -> (mapper target, candidate paths): the reference's
# candidates on both, ``materialize`` (the segmented ``ovsf_decompress``
# kernel on the card, then one product) and ``fused`` (``ovsf_gemm``); at
# the engine's decode shape the h100 target plans every LM weight type
# ``fused``
_PLAN_TARGETS = {"cuda": ("h100", mapper.DEFAULT_PATHS),
                 "cpu": ("cpu", mapper.DEFAULT_PATHS)}


def _decode_plan(cfg: ModelConfig, batch_slots: int, device,
                 calibration=None):
    """The mapper's decode plan for ``device``'s target and candidates."""
    hw, paths = _PLAN_TARGETS[torch.device(device).type]
    shape = ShapeConfig("serve_decode", 1, batch_slots, "decode")
    # weight_reuse=1, as the reference plans (its jit'd step cannot reuse
    # the eager decompress cache across steps)
    return mapper.plan_model(cfg, shape, hw=hw, paths=paths, weight_reuse=1,
                             calibration=calibration)


def plan_cfg(cfg: ModelConfig, batch_slots: int, device) -> ModelConfig:
    """``cfg`` carrying the mapper's decode plan for ``device`` (a config
    without OVSF layers, or with a plan already, is returned as it is)."""
    if not cfg.ovsf.enable or cfg.exec_plan is not None:
        return cfg
    return mapper.apply_plan(cfg, _decode_plan(cfg, batch_slots, device))


@dataclasses.dataclass
class EngineStats:
    steps: int = 0                # step calls
    tokens_out: int = 0
    prefills: int = 0             # requests whose prompt completed
    prefill_batches: int = 0      # legacy prefill calls (a group, or one
                                  # per request of an exact group)
    prefill_compiles: int = 0     # distinct prefill keys run (<= the number
                                  # of buckets when bucketing)
    step_compiles: int = 0        # distinct step shapes run
    chunk_tokens: int = 0         # prompt tokens consumed via chunks
    packed_tokens: int = 0        # valid (useful) tokens across all steps
    padded_tokens: int = 0        # batch tokens across all steps (incl. pad)
    completed: int = 0            # finished naturally (eos / length)
    rejected: int = 0
    preemptions: int = 0          # slot evictions for recompute (transient)
    recoveries: int = 0           # watchdog core rebuilds (exception/stall)
    stalls: int = 0               # steps longer than step_timeout_s
    timeouts: int = 0             # requests expired (FINISH_TIMEOUT)
    shed: int = 0                 # load-shed and dropped preempted requests
                                  # (FINISH_SHED / FINISH_PREEMPTED)
    errors: int = 0               # quarantined non-finite-logits requests
    cancelled: int = 0            # caller-cancelled (FINISH_CANCELLED)
    weight_cache_hits: int = 0    # decompress-cache counters of this
    weight_cache_misses: int = 0  # engine's model_label since construction
    weight_cache_entries: int = 0
    weight_cache_bytes: int = 0   # resident dense W of the label
    warmups: int = 0              # first steps of a shape on a core (on the
                                  # card: warm-up + CUDA-graph capture)
    warmup_s: float = 0.0         # their first calls' time, off the stall clock
    rebuild_s: float = 0.0        # watchdog rebuild time (old core freed, new
                                  # core built; its captures are warmup_s)
    prefill_s: float = 0.0        # legacy prefill groups' wall time
    decode_s: float = 0.0         # chunk-free step wall time
    mixed_s: float = 0.0          # chunk-bearing step wall time
    kv_pages_total: int = 0       # page pool size (0 unless paged)
    kv_pages_used: int = 0        # peak pages simultaneously granted
    kv_bytes_used: int = 0        # peak device bytes those pages pin

    @property
    def padding_efficiency(self) -> float:
        """Valid tokens / batch tokens (1.0 when nothing ran)."""
        return (self.packed_tokens / self.padded_tokens
                if self.padded_tokens else 1.0)

    @property
    def kv_utilization(self) -> float:
        """Peak fraction of the page pool holding live KV."""
        if not self.kv_pages_total:
            return 0.0
        return self.kv_pages_used / self.kv_pages_total


class LLMEngine:
    """Continuous-batching serving engine over a fixed set of slots.

    ``params`` must already live on ``device`` (``"cuda"`` by default; with
    no GPU present that raises unless ``device="cpu"`` is passed). On the
    card every step replays a CUDA graph, one per step shape
    (``EngineCore``); ``capture=False`` runs the same steps eagerly, for
    comparison. ``admission``, ``max_waiting``, ``step_timeout_s``,
    ``faults`` and ``journal`` are the reference's (module docstring)."""

    def __init__(self, params, cfg: ModelConfig, *, batch_slots: int = 4,
                 buffer_len: int = 256, eos_id: Optional[int] = None,
                 bucketed_prefill: bool = True, admission: str = "reject",
                 scheduler=None, chunk_size: Optional[int] = None,
                 max_step_tokens: Optional[int] = None,
                 packed: bool = False, paged: bool = False,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 calibrate: bool = False,
                 max_waiting: Optional[int] = None,
                 step_timeout_s: Optional[float] = None,
                 faults: Optional[FaultPlan] = None,
                 journal=None, device="cuda", capture: bool = True,
                 use_mapper: bool = True, variants: int = 0,
                 model_index=None, model_label: Optional[str] = None):
        self.device = resolve_device(device)
        self.variants = int(variants)
        self._model_index = model_index
        if self.variants and chunk_size is None:
            raise ValueError("variants>0 requires chunk_size (multi-model "
                             "steps serve prompts via chunk tasks)")
        if packed and chunk_size is None:
            raise ValueError("packed=True requires chunk_size (the packed "
                             "step serves prompts via chunk tasks)")
        if paged and chunk_size is None:
            raise ValueError("paged=True requires chunk_size (the paged "
                             "cache serves prompts via chunk tasks)")
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec",
                              "vlm"):
            raise NotImplementedError(f"family {cfg.family!r} is not ported")
        if chunk_size is not None and cfg.family in ("ssm", "hybrid"):
            warnings.warn(
                f"chunked prefill requires a KV-cache family (got "
                f"{cfg.family!r}: recurrent state would run through window "
                f"padding); falling back to phase-based serving",
                stacklevel=2)
            chunk_size = None
            packed = False
            paged = False
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"runs on {self.device}")
        self._base_cfg = cfg
        self.hw_label = _PLAN_TARGETS[self.device.type][0]
        # a stacked bank runs the multi path whatever a plan says
        use_mapper = use_mapper and not self.variants
        self.cfg = (plan_cfg(cfg, batch_slots, self.device) if use_mapper
                    else cfg)
        self.model_label = cfg.name if model_label is None else model_label
        self.params = params
        self.B = batch_slots
        self.eos = eos_id
        self.paged = paged
        if packed and max_step_tokens is None:
            # the mixed-step bucket: chunk-bearing steps fill their shape
            max_step_tokens = pack_bucket(0, batch_slots, chunk_size, True)
        self.max_step_tokens = max_step_tokens
        self.faults = faults
        self.step_timeout_s = step_timeout_s
        # what a watchdog rebuild of the core needs
        self._core_args = dict(batch_slots=batch_slots,
                               buffer_len=buffer_len, window=chunk_size or 0,
                               packed=packed, paged=paged,
                               page_size=page_size, kv_pages=kv_pages,
                               device=self.device, capture=capture,
                               faults=faults, variants=self.variants)
        self.core = EngineCore(params, self.cfg, **self._core_args)
        # padded batched prefill is exact for the KV-cache families only
        self.bucketed = bucketed_prefill and self.core.supports_bucketing
        pages = self.core.pager.P if paged else 0
        self.scheduler = scheduler if scheduler is not None else \
            FCFSScheduler(buffer_len, admission=admission,
                          bucketing=self.bucketed, chunk_size=chunk_size,
                          max_waiting=max_waiting,
                          page_size=page_size if paged else None,
                          total_pages=pages or None)
        if (packed or paged) and not hasattr(self.scheduler, "schedule"):
            raise ValueError(
                "packed/paged mode requires a step scheduler (schedule "
                "method): legacy add/next_group schedulers emit whole "
                "prefill groups, which this core cannot execute")
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.slot_remaining = np.zeros(batch_slots, np.int32)
        self._prefill_done = np.zeros(batch_slots, np.int64)
        self.stats = EngineStats(kv_pages_total=pages)
        self._finished: list[RequestOutput] = []
        self.calibrate = calibrate
        self.calibration = CalibrationTable()
        # write-ahead journal (None: not durable); flushed once a step
        self.journal = journal
        self._wc_base = kops.weight_cache_stats(self.model_label)

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit a request; False (and a ``rejected`` or ``shed`` output) if
        it would overflow the cache buffer or the page pool, or was shed
        from a full bounded queue."""
        req.t_submit = time.perf_counter()
        if self.journal is not None:
            # the admission record precedes any effect of the request
            self.journal.admit_request(req)
        admitted = self.scheduler.add(req)
        if not admitted:
            self._finalize(req)
        self._drain_shed()      # the bounded queue may have evicted a waiter
        return admitted

    def add_request(self, req: Request) -> tuple:
        """``submit`` plus the backpressure signal ``(admitted,
        backpressure)``: the waiting queue's fill fraction in [0, 1] (0.0
        when unbounded)."""
        admitted = self.submit(req)
        return admitted, self.backpressure

    @property
    def backpressure(self) -> float:
        return float(getattr(self.scheduler, "backpressure", 0.0))

    def outputs(self) -> list[RequestOutput]:
        """Finished requests (every terminal reason), in finish order."""
        return list(self._finished)

    # -- slots and commit --------------------------------------------------

    def _free_slots(self) -> list[int]:
        return [i for i in range(self.B) if self.slots[i] is None]

    def _running_view(self) -> list:
        return [(i, self.slots[i], int(self._prefill_done[i]))
                for i in range(self.B) if self.slots[i] is not None]

    def _schedule(self) -> SchedulerOutput:
        running, free = self._running_view(), self._free_slots()
        if hasattr(self.scheduler, "schedule"):
            return self.scheduler.schedule(
                running, free, token_budget=self.max_step_tokens,
                exact_prefill=not self.bucketed)
        # a legacy three-method scheduler (add / next_group / __len__)
        return legacy_schedule(self.scheduler, running, free,
                               not self.bucketed)

    def _commit_first_token(self, i: int, req: Request, tok: int) -> None:
        req.emit(tok)
        self._prefill_done[i] = req.prompt_len
        # out_tokens holds what a recomputed request generated before, so
        # its budget resumes where the eviction cut it
        self.slot_remaining[i] = req.max_new_tokens - len(req.out_tokens)
        self.stats.prefills += 1
        self.stats.tokens_out += 1
        if self.eos is not None and tok == self.eos:
            self._finish(i, FINISH_EOS)
        elif self.slot_remaining[i] <= 0:
            self._finish(i, FINISH_LENGTH)

    def _finish(self, i: int, reason: str) -> None:
        req = self.slots[i]
        req.finish_reason = reason
        self.slots[i] = None
        if self.paged:
            self.core.pager.release(i)
        self.core.clear_sampling(i)
        self._finalize(req)

    def _finalize(self, req: Request) -> None:
        """Book a terminal request: output record, per-reason counter, the
        journal's ``fin`` (durable before the result surfaces), and the
        exactly-once ``on_finish`` notification."""
        out = req.output()
        self._finished.append(out)
        r = req.finish_reason
        st = self.stats
        if r in (FINISH_EOS, FINISH_LENGTH):
            st.completed += 1
        elif r == FINISH_REJECTED:
            st.rejected += 1
        elif r == FINISH_TIMEOUT:
            st.timeouts += 1
        elif r in (FINISH_SHED, FINISH_PREEMPTED):
            st.shed += 1
        elif r == FINISH_ERROR:
            st.errors += 1
        elif r == FINISH_CANCELLED:
            st.cancelled += 1
        if self.journal is not None:
            self.journal.finish(req.rid, r)
        if req.on_finish is not None and not req._notified:
            req._notified = True
            req.on_finish(out)

    def _drain_shed(self) -> None:
        """Finalize the victims the scheduler took out of its bounded queue
        (already marked SHED or PREEMPTED)."""
        shed = getattr(self.scheduler, "shed", None)
        if shed:
            for req in shed:
                self._finalize(req)
            shed.clear()

    # -- the step loop -----------------------------------------------------

    def step(self) -> int:
        """One scheduler iteration: expire deadlines, schedule, evict the
        scheduler's preemption victim, grant pages (paged), run one step,
        commit. A step exception, or a step past ``step_timeout_s``, runs
        the watchdog (``_recover``) instead of propagating. Returns the
        remaining work (occupied slots plus queued requests; 0 = idle)."""
        self._expire_deadlines()
        self._drain_shed()
        so = self._schedule()
        for i in so.preempt_slots:      # evict + recompute-requeue
            self._requeue_slot(i, preempt=True)
        self._drain_shed()              # a requeue into a full queue sheds
        if self.paged:
            so = self._page_gate(so)    # grant pages / preempt on shortfall
            self._drain_shed()
        if so.empty:
            return self._remaining()
        last = np.zeros(self.B, np.int32)
        for i in so.decode_slots:
            last[i] = self.slots[i].out_tokens[-1]
        for c in so.chunks:             # bind newly admitted requests
            if c.start == 0:
                self.slots[c.slot] = c.req
                self._prefill_done[c.slot] = 0
                if self.variants:       # route the slot to its variant
                    self.core.model_ids[c.slot] = (
                        self._model_index(c.req.model)
                        if self._model_index is not None
                        and c.req.model is not None else 0)
        for pg in so.prefill_groups:    # legacy whole-prompt prefill
            for i, req in pg.slot_reqs:
                self.slots[i] = req
                self._prefill_done[i] = 0
        first = self.core.graphs.first_calls
        n_first = len(first)
        t0 = time.perf_counter()
        crashed = False
        try:
            # the decompress cache's entries and counters go to this
            # engine's model label
            with kops.weight_cache_scope(self.model_label):
                out = self.core.step(so, last)
        except Exception as exc:        # watchdog: the step crashed
            self._check_device(exc)
            crashed = True
        if crashed:
            # rebuilt after the handler: the traceback's frames, and the
            # failed step's tensors they hold, are freed before the new
            # core allocates
            self._recover()
            return self._remaining()
        # the stall watchdog measures around the core call, less the first
        # calls of new shapes; the step's output is valid, so it is
        # committed before the rebuild
        warm = sum(s for _key, s in first[n_first:])
        self.stats.warmups += len(first) - n_first
        self.stats.warmup_s += warm
        stalled = (self.step_timeout_s is not None
                   and time.perf_counter() - t0 - warm > self.step_timeout_s)
        self._commit(so, out)
        if self.journal is not None:
            self.journal.flush()        # group-commit this step's records
        if stalled:
            self.stats.stalls += 1
            self._recover()
        return self._remaining()

    def _check_device(self, exc: Exception) -> None:
        """Re-raise when the device no longer answers: a sticky CUDA error
        (a device-side trap) fails every later call, so only a new process
        recovers from it."""
        if self.device.type != "cuda":
            return
        try:
            torch.cuda.synchronize(self.device)
        except Exception as err:
            raise RuntimeError(
                "the CUDA context is lost: a step failed and the device no "
                "longer answers; restart the process (launch.serve "
                "--journal --supervise recovers every live request)"
            ) from err

    def _page_gate(self, so: SchedulerOutput) -> SchedulerOutput:
        """Grant KV pages for everything the scheduler just emitted.

        Running work (decodes, chunks continuing a started prompt) cannot
        wait, so a pool shortfall preempts the least urgent, youngest of
        those slots for recompute until the rest fits. A new prompt whose
        pages cannot be granted goes back to the waiting queue (its arrival
        order kept) and retries once pages are released."""
        pager = self.core.pager
        pos = self.core._host_pos
        decodes = list(so.decode_slots)
        run_chunks = [c for c in so.chunks if c.start > 0]
        new_chunks = [c for c in so.chunks if c.start == 0]

        def shortfall() -> int:
            need = (sum(pager.pages_needed(i, int(pos[i]) + 1)
                        for i in decodes)
                    + sum(pager.pages_needed(c.slot, c.start + c.length)
                          for c in run_chunks))
            return need - pager.free_pages

        while shortfall() > 0:
            cands = ([(i, self.slots[i]) for i in decodes]
                     + [(c.slot, self.slots[c.slot]) for c in run_chunks])
            if len(cands) <= 1:
                break   # one slot always fits: admission caps it at the pool
            victim = min(cands, key=lambda t: (t[1].priority,
                                               -(t[1]._sched_seq or 0)))[0]
            decodes = [i for i in decodes if i != victim]
            run_chunks = [c for c in run_chunks if c.slot != victim]
            self._requeue_slot(victim, preempt=True)    # releases its pages
        for i in decodes:
            pager.grant(i, int(pos[i]) + 1)
        for c in run_chunks:
            pager.grant(c.slot, c.start + c.length)
        kept_new = []
        for c in new_chunks:
            if pager.grant(c.slot, c.start + c.length):
                kept_new.append(c)
            else:
                self._requeue(c.req)
        keep = {id(c) for c in run_chunks} | {id(c) for c in kept_new}
        chunks = tuple(c for c in so.chunks if id(c) in keep)
        st = self.stats
        st.kv_pages_used = max(st.kv_pages_used, pager.used_pages)
        st.kv_bytes_used = max(st.kv_bytes_used, pager.used_bytes)
        return dataclasses.replace(
            so, decode_slots=tuple(decodes), chunks=chunks,
            n_scheduled_tokens=len(decodes) + sum(c.length for c in chunks))

    def _expire_deadlines(self) -> None:
        """Finish expired requests as FINISH_TIMEOUT: queued ones through
        the scheduler, running ones straight out of their slot."""
        if hasattr(self.scheduler, "pop_expired"):
            for req in self.scheduler.pop_expired(time.perf_counter()):
                self._finalize(req)
        for i in range(self.B):
            req = self.slots[i]
            if req is not None and req.expired:
                self._finish(i, FINISH_TIMEOUT)

    def _stash_slot(self, i: int) -> Request:
        """Evict slot ``i`` recompute-style and return its request: the
        prompt becomes original + generated tokens, prefill progress
        resets, the pages go back to the pool. No sampling state is kept:
        the next admission derives the key from the tokens emitted."""
        req = self.slots[i]
        self.slots[i] = None
        self.core.clear_sampling(i)
        if self.paged:
            self.core.pager.release(i)
        self._prefill_done[i] = 0
        self.slot_remaining[i] = 0
        if req.prompt_len_orig is None:
            req.prompt_len_orig = req.prompt_len
        # the tokens generated since the last rewrite
        new_tail = req.out_tokens[req.prompt_len - req.prompt_len_orig:]
        if new_tail:
            req.prompt = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(new_tail, np.int32)])
        return req

    def _requeue_slot(self, i: int, *, preempt: bool) -> None:
        """``_stash_slot`` and re-enqueue here; ``preempt=True`` books a
        preemption (a watchdog's requeue is not one)."""
        req = self._stash_slot(i)
        if preempt:
            req.preemptions += 1
            self.stats.preemptions += 1
        self._requeue(req)

    def _requeue(self, req: Request) -> None:
        """Back into the waiting queue, its arrival order kept; a legacy
        scheduler without ``requeue`` re-admits it FCFS."""
        if hasattr(self.scheduler, "requeue"):
            self.scheduler.requeue(req)
        else:
            self.scheduler.add(req)

    # -- hooks for callers: migration, crash recovery, drain, cancel ---------

    def adopt(self, req: Request) -> None:
        """Accept a request already admitted by an identically configured
        engine (a recomputed prompt keeps its total cache need), bypassing
        admission."""
        self._requeue(req)
        self._drain_shed()

    def recover_from_journal(self, *, wire=None) -> list:
        """Crash recovery: re-admit every non-terminal journaled request
        through the recompute path, in admission order, and return them.
        A request whose deadline passed while the process was down
        finishes ``FINISH_TIMEOUT`` here (``on_finish`` once). ``wire(req)``
        may attach callbacks before each request is adopted or finalized.
        The journal is compacted afterwards."""
        if self.journal is None:
            return []
        recovered = []
        for entry in self.journal.live_entries():
            req = entry.to_request()
            if wire is not None:
                wire(req)
            if req.expired:
                req.finish_reason = FINISH_TIMEOUT
                self._finalize(req)
                continue
            self.adopt(req)
            recovered.append(req)
        self.journal.compact()
        return recovered

    def drain_requests(self) -> list:
        """Strip every live request off this engine: running slots evicted
        recompute-style, then the waiting queue in priority-FCFS order. The
        engine is left empty and usable."""
        out = [self._stash_slot(i) for i in range(self.B)
               if self.slots[i] is not None]
        if hasattr(self.scheduler, "pop_all"):
            out.extend(self.scheduler.pop_all())
        else:                           # a legacy scheduler: FCFS groups
            while len(self.scheduler):
                pg = self.scheduler.next_group(self.B)
                if pg is None:
                    break
                out.extend(pg.requests)
        return out

    def cancel(self, req: Request) -> bool:
        """Cancel one live request: a running one finishes
        FINISH_CANCELLED with its slot and pages freed at once, a queued
        one is withdrawn. False when it is not live here."""
        if req.done:
            return False
        for i in range(self.B):
            if self.slots[i] is req:
                self._finish(i, FINISH_CANCELLED)
                return True
        if hasattr(self.scheduler, "remove") and self.scheduler.remove(req):
            req.finish_reason = FINISH_CANCELLED
            self._finalize(req)
            return True
        return False

    def _recover(self) -> None:
        """Watchdog recovery: requeue every live slot recompute-style, free
        the old core (caches, graphs, graph pools), and build a new one that
        carries ``step_idx``, ``step_shapes`` and ``prefill_compiles`` over,
        so a step-pinned fault fires once a run (the new core runs its
        prefill keys anew, as the reference's traces its prefills anew)."""
        for i in range(self.B):
            if self.slots[i] is not None:
                self._requeue_slot(i, preempt=False)
        self._drain_shed()
        t0 = time.perf_counter()
        old = self.core
        old.close()
        self.core = EngineCore(self.params, self.cfg, **self._core_args)
        self.core.step_idx = old.step_idx
        self.core.step_shapes = old.step_shapes
        self.core.prefill_compiles = old.prefill_compiles
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # the new caches' zeros
        self.stats.rebuild_s += time.perf_counter() - t0
        self.stats.recoveries += 1

    def _remaining(self) -> int:
        return (sum(s is not None for s in self.slots)
                + len(self.scheduler))

    def _commit(self, so: SchedulerOutput, out: StepOutput) -> None:
        for c in so.chunks:
            self._prefill_done[c.slot] += c.length
        self.stats.chunk_tokens += sum(c.length for c in so.chunks)
        for i in out.bad_slots:         # NaN quarantine: the request ends
            self._finish(i, FINISH_ERROR)
        for i, tok in out.first_tokens.items():
            # the token is journaled before any finish it triggers
            if self.journal is not None:
                self.journal.tokens(self.slots[i].rid, (tok,))
            self._commit_first_token(i, self.slots[i], tok)
        for i, tok in out.decode_tokens.items():
            req = self.slots[i]
            if self.journal is not None:
                self.journal.tokens(req.rid, (tok,))
            req.emit(tok)
            self.stats.tokens_out += 1
            self.slot_remaining[i] -= 1
            if self.eos is not None and tok == self.eos:
                self._finish(i, FINISH_EOS)
            elif self.slot_remaining[i] <= 0:
                self._finish(i, FINISH_LENGTH)
        st = self.stats
        st.prefill_s += out.prefill_s
        st.decode_s += out.decode_s
        st.mixed_s += out.mixed_s
        st.packed_tokens += out.n_valid_tokens
        st.padded_tokens += out.n_batch_tokens
        if so.decode_slots or so.chunks:
            st.steps += 1
        st.prefill_batches += sum(len(pg.slot_reqs) if pg.exact else 1
                                  for pg in so.prefill_groups)
        st.prefill_compiles = self.core.prefill_compiles
        st.step_compiles = len(self.core.step_shapes)
        wc = kops.weight_cache_stats(self.model_label)
        st.weight_cache_hits = wc["hits"] - self._wc_base["hits"]
        st.weight_cache_misses = wc["misses"] - self._wc_base["misses"]
        st.weight_cache_entries = wc["entries"]
        st.weight_cache_bytes = wc["bytes"]
        if (self.calibrate and out.decode_s > 0.0 and not so.chunks
                and not so.prefill_groups
                and self.cfg.exec_plan is not None):
            update_from_step(self.calibration, self.cfg.exec_plan,
                             out.decode_s, self.hw_label)

    def run_until_drained(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return self.stats

    # -- measured-vs-modeled calibration -----------------------------------

    def replan(self):
        """The decode plan the mapper gives under the accumulated
        calibration table, with the engine's own target and candidate paths
        (so on the card a plan the card can run). Compare it with
        ``self.cfg.exec_plan`` to see what the loop re-maps; the engine
        keeps its plan (build a new engine to adopt this one: its step
        graphs hold the plan's kernels and the params' addresses)."""
        return _decode_plan(self._base_cfg, self.B, self.device,
                            self.calibration)
