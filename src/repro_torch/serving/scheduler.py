"""Step scheduling and the token-packed layout (port of
``repro.serving.scheduler``).

``FCFSScheduler.schedule`` emits one :class:`SchedulerOutput` per engine
iteration. Chunked mode (``chunk_size`` set): every running decode slot
advances one token, and the rest of the token budget goes to fixed-size
prompt chunks (highest priority first, FCFS within a level, partial
prefills before new admissions), and under ``admission="preempt"`` the
slot to evict for a more urgent waiter. Legacy phase-based mode
(``chunk_size=None``): every running slot decodes and the free slots fill
with whole prefill groups (``next_group``: the head of the queue plus
younger requests of its length bucket, ``bucket_lengths``). The scheduler
also bounds the waiting queue (load shedding) and expires deadlines.
``pack_step`` flattens a step into the dense ``(T,)`` token stream of one
packed step. ``legacy_schedule`` adapts any ``add`` / ``next_group`` /
``__len__`` scheduler onto the step contract.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.ovsf import next_pow2
from repro_torch.serving.api import (FINISH_PREEMPTED, FINISH_REJECTED,
                                     FINISH_SHED, FINISH_TIMEOUT, Request)


def bucket_lengths(buffer_len: int, *, min_bucket: int = 8,
                   n_buckets: int = 0) -> tuple[int, ...]:
    """Power-of-two prefill buckets from ``min_bucket`` up to the buffer,
    the last one clamped to ``buffer_len`` so that a near-capacity prompt
    still fits after padding (the last ``n_buckets`` when that is set)."""
    out: list[int] = []
    b = max(min_bucket, 1)
    while b < buffer_len:
        out.append(b)
        b *= 2
    out.append(buffer_len)
    if n_buckets and len(out) > n_buckets:
        out = out[-n_buckets:]
    return tuple(out)


def bucket_for(plen: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= plen (admission guarantees one exists)."""
    for b in buckets:
        if plen <= b:
            return b
    raise ValueError(f"prompt length {plen} exceeds largest bucket "
                     f"{buckets[-1]}")


@dataclasses.dataclass
class PrefillGroup:
    """Same-bucket requests to prefill in one batched call."""
    bucket: int
    requests: list


@dataclasses.dataclass(frozen=True)
class ChunkTask:
    """``req.prompt[start : start + length]`` rides in slot ``slot`` this
    step; ``last`` marks the slice that completes the prompt (its sampled
    token is the request's first output token)."""
    slot: int
    req: Request
    start: int
    length: int
    last: bool


@dataclasses.dataclass(frozen=True)
class PrefillAssignment:
    """Legacy phase-based prefill: one bucketed (or, ``exact``, native
    length per request) group mapped onto concrete slots."""
    bucket: int
    slot_reqs: tuple          # ((slot, Request), ...)
    exact: bool = False


@dataclasses.dataclass(frozen=True)
class SchedulerOutput:
    """What the engine core executes in ONE ``step()`` iteration: chunked
    mode fills ``decode_slots`` and ``chunks`` (one call), legacy mode
    ``decode_slots`` and ``prefill_groups`` (the groups first, then the
    decode). ``preempt_slots`` are running slots the engine evicts before
    the step (excluded from ``decode_slots`` and ``chunks``; their requests
    are re-enqueued for recompute)."""
    decode_slots: tuple = ()        # slots advancing one generated token
    chunks: tuple = ()              # ChunkTask prompt slices this step
    prefill_groups: tuple = ()      # PrefillAssignment (legacy mode)
    preempt_slots: tuple = ()       # slots to evict + recompute-requeue
    n_scheduled_tokens: int = 0

    @property
    def empty(self) -> bool:
        return not (self.decode_slots or self.chunks or self.prefill_groups
                    or self.preempt_slots)


@dataclasses.dataclass(frozen=True)
class PackedStep:
    """The flattened token layout of one packed engine step: every valid
    token of the iteration in one ``(T,)`` stream with per-token slot ids and
    positions, ``T`` the pow-2 bucket; indices ``>= n_valid`` are padding
    (``slot_id == B``)."""
    tokens: np.ndarray        # (T,) int32; padding tail is 0
    slot_ids: np.ndarray      # (T,) int32; padding tokens carry B
    positions: np.ndarray     # (T,) int32 cache position of each token
    new_pos: np.ndarray       # (B,) post-step fill level per slot
    emit_idx: np.ndarray      # (B,) packed index of slot b's last valid token
    emit_slots: tuple         # slots whose sampled token is consumed
    cu_seqlens: np.ndarray    # (n_segments + 1,) segment boundaries
    seg_slots: tuple          # slot of each segment
    seg_kinds: tuple          # "decode" | "chunk" per segment
    n_valid: int              # valid tokens; the rest of T is padding

    @property
    def n_batch(self) -> int:
        return int(self.tokens.shape[0])


def pack_bucket(n_valid: int, B: int, chunk: int, has_chunks: bool) -> int:
    """Pow-2 token bucket of a packed step: ``next_pow2(B)`` for pure
    decode; at least ``next_pow2(B + chunk)`` once any chunk is scheduled."""
    if not has_chunks:
        return max(next_pow2(max(B, 1)), 1)
    return max(next_pow2(max(n_valid, 1)), next_pow2(B + chunk))


def pack_step(so: SchedulerOutput, last_tokens, slot_pos, B: int,
              chunk: int) -> PackedStep:
    """Flatten one ``SchedulerOutput`` into the packed token layout:
    decode slots first (their last generated token at their fill level),
    then chunks in scheduler order."""
    toks: list = []
    sids: list = []
    poss: list = []
    cu = [0]
    seg_slots: list = []
    seg_kinds: list = []
    new_pos = np.asarray(slot_pos, dtype=np.int64).copy()
    emit_idx = np.zeros(B, np.int64)
    emit_slots: list = []
    for i in so.decode_slots:
        p = int(slot_pos[i])
        toks.append(int(last_tokens[i]))
        sids.append(i)
        poss.append(p)
        emit_idx[i] = len(toks) - 1
        emit_slots.append(i)
        new_pos[i] = p + 1
        cu.append(len(toks))
        seg_slots.append(i)
        seg_kinds.append("decode")
    for c in so.chunks:
        toks.extend(int(t) for t in c.req.prompt[c.start:c.start + c.length])
        sids.extend([c.slot] * c.length)
        poss.extend(range(c.start, c.start + c.length))
        new_pos[c.slot] = c.start + c.length
        if c.last:
            emit_idx[c.slot] = len(toks) - 1
            emit_slots.append(c.slot)
        cu.append(len(toks))
        seg_slots.append(c.slot)
        seg_kinds.append("chunk")
    n = len(toks)
    Tb = pack_bucket(n, B, chunk, bool(so.chunks))
    tokens = np.zeros(Tb, np.int32)
    tokens[:n] = toks
    slot_ids = np.full(Tb, B, np.int32)     # padding rows: the sentinel slot
    slot_ids[:n] = sids
    positions = np.zeros(Tb, np.int32)
    positions[:n] = poss
    return PackedStep(tokens=tokens, slot_ids=slot_ids, positions=positions,
                      new_pos=new_pos, emit_idx=emit_idx,
                      emit_slots=tuple(emit_slots),
                      cu_seqlens=np.asarray(cu, np.int64),
                      seg_slots=tuple(seg_slots), seg_kinds=tuple(seg_kinds),
                      n_valid=n)


def unpack_step(ps: PackedStep) -> tuple[tuple, tuple]:
    """The inverse of ``pack_step``'s layout: ``(decode_slots, ((slot,
    start, length), ...))`` recovered from the segment boundaries."""
    decode: list = []
    chunks: list = []
    for s in range(len(ps.cu_seqlens) - 1):
        a, b = int(ps.cu_seqlens[s]), int(ps.cu_seqlens[s + 1])
        slot = ps.seg_slots[s]
        if ps.seg_kinds[s] == "decode":
            if b - a != 1:
                raise ValueError(f"unpack_step: decode segment {s} holds "
                                 f"{b - a} tokens")
            decode.append(slot)
        else:
            chunks.append((slot, int(ps.positions[a]), b - a))
    return tuple(decode), tuple(chunks)


class FCFSScheduler:
    """Priority-FCFS admission and step scheduling, chunked or (with
    ``chunk_size=None``) legacy phase-based with length buckets
    (``bucketing=False``: one exact-length "bucket" a prompt length).

    ``admission``: ``"reject"`` marks a request whose prompt plus
    ``max_new_tokens`` would overflow the buffer (or, paged, the whole page
    pool) FINISH_REJECTED at ``add``; ``"truncate"`` clamps
    ``max_new_tokens`` to what fits (a prompt longer than ``buffer_len -
    1`` is rejected either way); ``"preempt"`` admits like ``"reject"`` and
    also evicts the least urgent running slot when a strictly more urgent
    request waits and no slot is free (``SchedulerOutput.preempt_slots``):
    the victim is recomputed, not lost; it needs ``chunk_size``.

    The waiting queue is ordered by priority (higher first), FCFS within a
    level. With ``max_waiting`` it is bounded and an overload sheds the
    least urgent request (the new one, or a less urgent waiter) as
    FINISH_SHED; victims taken out of the queue land in ``self.shed`` for
    the engine to finalize.
    """

    def __init__(self, buffer_len: int, *, admission: str = "reject",
                 min_bucket: int = 8, bucketing: bool = True,
                 chunk_size: Optional[int] = None,
                 max_waiting: Optional[int] = None,
                 page_size: Optional[int] = None,
                 total_pages: Optional[int] = None):
        if admission not in ("reject", "truncate", "preempt"):
            raise ValueError(f"admission policy {admission!r}")
        if admission == "preempt" and chunk_size is None:
            raise ValueError(
                "admission='preempt' requires chunk_size: preempted "
                "requests are recomputed via chunked prefill")
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if max_waiting is not None and max_waiting < 1:
            raise ValueError(f"max_waiting must be >= 1, got {max_waiting}")
        self.buffer_len = buffer_len
        self.admission = admission
        self.bucketing = bucketing
        self.chunk_size = chunk_size
        self.max_waiting = max_waiting
        # paged admission: a request whose whole lifetime exceeds the ENTIRE
        # pool could never run even alone; transient pool pressure is the
        # engine's page gate's (wait, or preempt and recompute)
        self.page_size = page_size
        self.total_pages = total_pages
        self.buckets = bucket_lengths(buffer_len, min_bucket=min_bucket)
        self.waiting: list[Request] = []
        self.shed: list[Request] = []   # load-shed victims awaiting finalize
        self._seq = 0

    def __len__(self) -> int:
        return len(self.waiting)

    @property
    def backpressure(self) -> float:
        """Queue fill fraction in [0, 1]; 0.0 when unbounded."""
        if not self.max_waiting:
            return 0.0
        return min(len(self.waiting) / self.max_waiting, 1.0)

    def _key(self, req: Request):
        return (-req.priority, req._sched_seq)

    def _sorted_idx(self) -> list[int]:
        return sorted(range(len(self.waiting)),
                      key=lambda i: self._key(self.waiting[i]))

    def _peek(self) -> Optional[Request]:
        if not self.waiting:
            return None
        return min(self.waiting, key=self._key)

    def _pop_next(self) -> Request:
        i = min(range(len(self.waiting)),
                key=lambda i: self._key(self.waiting[i]))
        return self.waiting.pop(i)

    def _shed_victim_idx(self) -> int:
        """Least urgent queued request: lowest priority, youngest within."""
        return max(range(len(self.waiting)),
                   key=lambda i: (-self.waiting[i].priority,
                                  self.waiting[i]._sched_seq))

    def add(self, req: Request) -> bool:
        """Admit, reject (FINISH_REJECTED) or load-shed (FINISH_SHED)."""
        plen = req.prompt_len
        cap = self.buffer_len - plen
        if self.page_size and self.total_pages:
            cap = min(cap, self.total_pages * self.page_size - plen)
        overflow = req.max_new_tokens > cap
        if plen < 1 or plen > self.buffer_len - 1 or cap < 1 or (
                overflow and self.admission != "truncate"):
            req.finish_reason = FINISH_REJECTED
            return False
        if overflow:                    # admission == "truncate"
            req.max_new_tokens = cap
        if req._sched_seq is None:
            req._sched_seq = self._seq
            self._seq += 1
        if self.max_waiting and len(self.waiting) >= self.max_waiting:
            vi = self._shed_victim_idx()
            if self.waiting[vi].priority < req.priority:
                victim = self.waiting.pop(vi)   # evict a less urgent waiter
                victim.finish_reason = FINISH_SHED
                self.shed.append(victim)
            else:
                req.finish_reason = FINISH_SHED
                return False
        self.waiting.append(req)
        return True

    def requeue(self, req: Request) -> bool:
        """Re-enqueue an admitted request (preempted, recovered, or a new
        prompt whose pages could not be granted), its arrival order kept.
        Into a full bounded queue it displaces a less urgent waiter, or is
        dropped as FINISH_PREEMPTED when every waiter is at least as
        urgent (the one case preemption is lossy)."""
        if self.max_waiting and len(self.waiting) >= self.max_waiting:
            vi = self._shed_victim_idx()
            victim = self.waiting[vi]
            if (victim.priority, -victim._sched_seq) < (req.priority,
                                                        -req._sched_seq):
                self.waiting.pop(vi)
                victim.finish_reason = FINISH_SHED
                self.shed.append(victim)
            else:
                req.finish_reason = FINISH_PREEMPTED
                self.shed.append(req)
                return False
        self.waiting.append(req)
        return True

    def remove(self, req: Request) -> bool:
        """Withdraw one queued request (cancellation): True iff it was
        waiting. The caller finalizes it."""
        try:
            self.waiting.remove(req)
            return True
        except ValueError:
            return False

    def pop_all(self) -> list[Request]:
        """Drain the waiting queue in priority-FCFS order."""
        out = sorted(self.waiting, key=self._key)
        self.waiting = []
        return out

    def pop_expired(self, now: float) -> list[Request]:
        """Remove and return the waiting requests past their deadline
        (marked FINISH_TIMEOUT; the engine finalizes them)."""
        expired = [r for r in self.waiting
                   if r.deadline_s is not None and r.t_submit > 0.0
                   and now - r.t_submit > r.deadline_s]
        if expired:
            self.waiting = [r for r in self.waiting if r not in expired]
            for r in expired:
                r.finish_reason = FINISH_TIMEOUT
        return expired

    def bucket_of(self, req: Request) -> int:
        if not self.bucketing:
            return req.prompt_len        # exact-length "bucket" per request
        return bucket_for(req.prompt_len, self.buckets)

    def next_group(self, max_size: int) -> Optional[PrefillGroup]:
        """Pop the next prefill group: the head of the queue (highest
        priority, oldest within) plus up to ``max_size - 1`` younger
        requests of its bucket, in queue order."""
        if not self.waiting or max_size < 1:
            return None
        order = self._sorted_idx()
        bucket = self.bucket_of(self.waiting[order[0]])
        picked_idx = [i for i in order
                      if self.bucket_of(self.waiting[i]) == bucket][:max_size]
        picked = [self.waiting[i] for i in picked_idx]
        taken = set(picked_idx)
        self.waiting = [r for i, r in enumerate(self.waiting)
                        if i not in taken]
        return PrefillGroup(bucket, picked)

    def schedule(self, running, free_slots, *,
                 token_budget: Optional[int] = None,
                 exact_prefill: bool = False) -> SchedulerOutput:
        """Emit one step's worth of work.

        ``running`` is ``[(slot, Request, prefill_done)]`` for occupied
        slots (``prefill_done == prompt_len`` means the slot decodes);
        ``free_slots`` are unoccupied slot ids. Legacy mode: every running
        slot decodes and the free slots fill with whole prefill groups
        (``exact_prefill``: native-length prefill per request). Chunked
        mode: under ``admission="preempt"``, when no slot is free and the
        waiting head is strictly more urgent than the least urgent running
        slot, that slot goes to ``preempt_slots`` (at most one a step) and
        gets no work this step. Decodes are always scheduled; the rest of
        ``token_budget`` is split across prompt chunks of at most
        ``chunk_size`` tokens, and a mid-prefill slot always progresses by
        at least one token.
        """
        if self.chunk_size is None:
            return legacy_schedule(self, running, free_slots, exact_prefill)
        chunk = self.chunk_size
        preempt: tuple = ()
        if self.admission == "preempt" and running and not free_slots:
            head = self._peek()
            vslot, vreq, _vd = min(
                running, key=lambda t: (t[1].priority, -(t[1]._sched_seq
                                                         or 0)))
            if head is not None and head.priority > vreq.priority:
                preempt = (vslot,)
                running = [t for t in running if t[0] != vslot]
        decodes = [s for s, req, done in running if done >= req.prompt_len]
        budget = (token_budget if token_budget is not None
                  else len(decodes) + chunk * max(len(running)
                                                  + len(free_slots), 1))
        budget -= len(decodes)
        chunks: list[ChunkTask] = []
        for slot, req, done in running:
            remaining = req.prompt_len - done
            if remaining <= 0:
                continue
            take = min(chunk, remaining, max(budget, 1))
            chunks.append(ChunkTask(slot, req, done, take,
                                    done + take >= req.prompt_len))
            budget -= take
        for slot in free_slots:
            if not self.waiting or budget <= 0:
                break
            req = self._pop_next()
            # a recomputed request prefills its whole rewritten prompt
            # (original + generated tokens) from position 0
            take = min(chunk, req.prompt_len, budget)
            chunks.append(ChunkTask(slot, req, 0, take,
                                    take >= req.prompt_len))
            budget -= take
        n_tok = len(decodes) + sum(c.length for c in chunks)
        return SchedulerOutput(decode_slots=tuple(decodes),
                               chunks=tuple(chunks),
                               preempt_slots=preempt,
                               n_scheduled_tokens=n_tok)


def legacy_schedule(scheduler, running, free_slots,
                    exact_prefill: bool) -> SchedulerOutput:
    """Any ``add`` / ``next_group`` / ``__len__`` scheduler on the step
    contract: every running slot decodes, the free slots fill with whole
    prefill groups. Shared by ``FCFSScheduler`` (``chunk_size=None``) and
    the engine's adapter for such schedulers."""
    decodes = tuple(s for s, _req, _d in running)
    groups: list[PrefillAssignment] = []
    free = list(free_slots)
    while free and len(scheduler):
        g = scheduler.next_group(len(free))
        if g is None or not g.requests:
            break
        groups.append(PrefillAssignment(
            g.bucket, tuple(zip(free, g.requests)), exact=exact_prefill))
        free = free[len(g.requests):]
    n_tok = len(decodes) + sum(r.prompt_len for pg in groups
                               for _s, r in pg.slot_reqs)
    return SchedulerOutput(decode_slots=decodes,
                           prefill_groups=tuple(groups),
                           n_scheduled_tokens=n_tok)
