"""LLMEngine: step-based serving over chunked prompts (port of
``repro.serving.engine``).

Each ``step()``: the :class:`~repro_torch.serving.scheduler.FCFSScheduler`
emits one :class:`SchedulerOutput` (running decode slots plus fixed-size
prompt chunks), ``_page_gate`` grants the KV pages it needs when the cache
is paged, and the :class:`~repro_torch.serving.core.EngineCore` runs it as
ONE step in the engine's style (contiguous or paged cache, window or
packed step) with fused sampling; this module tracks slots, prefill
progress, finish reasons, streaming callbacks and the ``EngineStats``
counters.

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

``chunk_size`` is required: the legacy phase-based path (whole-prompt
prefill groups), the int8 KV cache, preemption, deadlines, load shedding,
fault injection and the journal wait for later slices (ROADMAP A.3, A.4).
A page-pool shortfall for running work raises ``RuntimeError``: the
default pool (``slots * buffer_len / page_size`` pages) never runs short.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.runtime import mapper
from repro_torch.runtime.calibrate import CalibrationTable, update_from_step
from repro_torch.serving.api import (FINISH_EOS, FINISH_ERROR,
                                     FINISH_LENGTH, FINISH_REJECTED, Request,
                                     RequestOutput, SamplingParams)
from repro_torch.serving.core import EngineCore, StepOutput
from repro_torch.serving.scheduler import (FCFSScheduler, SchedulerOutput,
                                           pack_bucket)

__all__ = ["LLMEngine", "EngineStats", "Request", "SamplingParams",
           "RequestOutput", "plan_cfg"]

# device type -> (mapper target, candidate paths): on the card
# ``materialize`` and ``spectral`` of the LM layers' segmented codes are
# plain tensor code, so the mapper may pick only the path the CUDA
# ``ovsf_gemm`` runs
_PLAN_TARGETS = {"cuda": ("h100", ("fused",)),
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
    chunk_tokens: int = 0         # prompt tokens consumed via chunks
    packed_tokens: int = 0        # valid (useful) tokens across all steps
    padded_tokens: int = 0        # batch tokens across all steps (incl. pad)
    completed: int = 0            # finished naturally (eos / length)
    rejected: int = 0
    errors: int = 0               # quarantined non-finite-logits requests
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
    comparison."""

    def __init__(self, params, cfg: ModelConfig, *, batch_slots: int = 4,
                 buffer_len: int = 256, eos_id: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 max_step_tokens: Optional[int] = None,
                 packed: bool = False, paged: bool = False,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 calibrate: bool = False, device="cuda",
                 capture: bool = True):
        self.device = resolve_device(device)
        if chunk_size is None:
            raise NotImplementedError(
                "the port serves prompts via chunks only: pass chunk_size; "
                "the legacy phase-based path (chunk_size=None) waits for a "
                "later slice (ROADMAP A.3)")
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported")
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"runs on {self.device}")
        self._base_cfg = cfg
        self.hw_label = _PLAN_TARGETS[self.device.type][0]
        self.cfg = plan_cfg(cfg, batch_slots, self.device)
        self.params = params
        self.B = batch_slots
        self.eos = eos_id
        self.paged = paged
        if packed and max_step_tokens is None:
            # the mixed-step bucket: chunk-bearing steps fill their shape
            max_step_tokens = pack_bucket(0, batch_slots, chunk_size, True)
        self.max_step_tokens = max_step_tokens
        self.core = EngineCore(params, self.cfg, batch_slots=batch_slots,
                               buffer_len=buffer_len, window=chunk_size,
                               packed=packed, paged=paged,
                               page_size=page_size, kv_pages=kv_pages,
                               device=self.device, capture=capture)
        pages = self.core.pager.P if paged else 0
        self.scheduler = FCFSScheduler(buffer_len, chunk_size=chunk_size,
                                       page_size=page_size if paged else None,
                                       total_pages=pages or None)
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.slot_remaining = np.zeros(batch_slots, np.int32)
        self._prefill_done = np.zeros(batch_slots, np.int64)
        self.stats = EngineStats(kv_pages_total=pages)
        self._finished: list[RequestOutput] = []
        self.calibrate = calibrate
        self.calibration = CalibrationTable()

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit a request; False (and a ``rejected`` output) if it would
        overflow the cache buffer or the page pool."""
        req.t_submit = time.perf_counter()
        admitted = self.scheduler.add(req)
        if not admitted:
            self._finalize(req)
        return admitted

    def add_request(self, req: Request) -> tuple:
        """``submit`` plus the backpressure signal ``(admitted,
        backpressure)``; the waiting queue is unbounded here, so
        backpressure is always 0.0."""
        return self.submit(req), 0.0

    def outputs(self) -> list[RequestOutput]:
        """Finished (completed + rejected) requests, in finish order."""
        return list(self._finished)

    # -- slots and commit --------------------------------------------------

    def _free_slots(self) -> list[int]:
        return [i for i in range(self.B) if self.slots[i] is None]

    def _running_view(self) -> list:
        return [(i, self.slots[i], int(self._prefill_done[i]))
                for i in range(self.B) if self.slots[i] is not None]

    def _commit_first_token(self, i: int, req: Request, tok: int) -> None:
        req.emit(tok)
        self._prefill_done[i] = req.prompt_len
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
        """Book a terminal request: output record, per-reason counter, and
        the exactly-once ``on_finish`` notification."""
        out = req.output()
        self._finished.append(out)
        r = req.finish_reason
        st = self.stats
        if r in (FINISH_EOS, FINISH_LENGTH):
            st.completed += 1
        elif r == FINISH_REJECTED:
            st.rejected += 1
        elif r == FINISH_ERROR:
            st.errors += 1
        if req.on_finish is not None and not req._notified:
            req._notified = True
            req.on_finish(out)

    # -- the step loop -----------------------------------------------------

    def step(self) -> int:
        """One scheduler iteration: schedule, grant pages (paged), run one
        step, commit. Returns the remaining work (occupied slots plus
        queued requests; 0 = idle)."""
        so = self.scheduler.schedule(self._running_view(), self._free_slots(),
                                     token_budget=self.max_step_tokens)
        if self.paged:
            so = self._page_gate(so)
        if so.empty:
            return self._remaining()
        last = np.zeros(self.B, np.int32)
        for i in so.decode_slots:
            last[i] = self.slots[i].out_tokens[-1]
        for c in so.chunks:             # bind newly admitted requests
            if c.start == 0:
                self.slots[c.slot] = c.req
                self._prefill_done[c.slot] = 0
        out = self.core.step(so, last)
        self._commit(so, out)
        return self._remaining()

    def _page_gate(self, so: SchedulerOutput) -> SchedulerOutput:
        """Grant KV pages for everything the scheduler just emitted. Running
        work (decodes, continuing chunks) must fit; a new prompt whose pages
        cannot be granted goes back to the waiting queue and retries next
        step."""
        pager = self.core.pager
        pos = self.core._host_pos
        decodes = list(so.decode_slots)
        run_chunks = [c for c in so.chunks if c.start > 0]
        need = (sum(pager.pages_needed(i, int(pos[i]) + 1) for i in decodes)
                + sum(pager.pages_needed(c.slot, c.start + c.length)
                      for c in run_chunks))
        if need > pager.free_pages:
            raise RuntimeError(
                f"KV page pool exhausted: running work needs {need} pages, "
                f"{pager.free_pages} free; preemption-and-recompute is not "
                f"ported yet — raise kv_pages (the default, slots * "
                f"buffer_len / page_size, never runs short)")
        for i in decodes:
            pager.grant(i, int(pos[i]) + 1)
        for c in run_chunks:
            pager.grant(c.slot, c.start + c.length)
        chunks = []
        for c in so.chunks:
            if c.start > 0 or pager.grant(c.slot, c.start + c.length):
                chunks.append(c)
            else:
                self.scheduler.requeue(c.req)
        st = self.stats
        st.kv_pages_used = max(st.kv_pages_used, pager.used_pages)
        st.kv_bytes_used = max(st.kv_bytes_used, pager.used_bytes)
        return dataclasses.replace(
            so, chunks=tuple(chunks),
            n_scheduled_tokens=len(decodes) + sum(c.length for c in chunks))

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
            self._commit_first_token(i, self.slots[i], tok)
        for i, tok in out.decode_tokens.items():
            req = self.slots[i]
            req.emit(tok)
            self.stats.tokens_out += 1
            self.slot_remaining[i] -= 1
            if self.eos is not None and tok == self.eos:
                self._finish(i, FINISH_EOS)
            elif self.slot_remaining[i] <= 0:
                self._finish(i, FINISH_LENGTH)
        st = self.stats
        st.decode_s += out.decode_s
        st.mixed_s += out.mixed_s
        st.packed_tokens += out.n_valid_tokens
        st.padded_tokens += out.n_batch_tokens
        if so.decode_slots or so.chunks:
            st.steps += 1
        if (self.calibrate and out.decode_s > 0.0 and not so.chunks
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
