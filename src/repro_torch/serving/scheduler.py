"""Step scheduling and the token-packed layout (copy of what the packed
path needs from ``repro.serving.scheduler``).

``FCFSScheduler.schedule`` emits one :class:`SchedulerOutput` per engine
iteration: every running decode slot advances one token, and the rest of
the token budget goes to fixed-size prompt chunks (highest priority first,
FCFS within a level, partial prefills before new admissions). ``pack_step``
flattens that into the dense ``(T,)`` token stream of one packed step. The
legacy phase-based mode, load shedding, deadlines and preemption wait for
later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.ovsf import next_pow2
from repro_torch.serving.api import FINISH_REJECTED, Request


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
class SchedulerOutput:
    """What the engine core executes in ONE ``step()`` iteration."""
    decode_slots: tuple = ()        # slots advancing one generated token
    chunks: tuple = ()              # ChunkTask prompt slices this step
    n_scheduled_tokens: int = 0

    @property
    def empty(self) -> bool:
        return not (self.decode_slots or self.chunks)


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


class FCFSScheduler:
    """Priority-FCFS admission and chunked step scheduling.

    ``add`` rejects (FINISH_REJECTED) a request whose prompt plus
    ``max_new_tokens`` would not fit the buffer, or — paged — the whole
    page pool. The waiting queue is ordered by priority (higher first), FCFS
    within a level.
    """

    def __init__(self, buffer_len: int, *, chunk_size: int,
                 page_size: Optional[int] = None,
                 total_pages: Optional[int] = None):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.buffer_len = buffer_len
        self.chunk_size = chunk_size
        self.page_size = page_size
        self.total_pages = total_pages
        self.waiting: list[Request] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self.waiting)

    def _key(self, req: Request):
        return (-req.priority, req._sched_seq)

    def _pop_next(self) -> Request:
        i = min(range(len(self.waiting)),
                key=lambda i: self._key(self.waiting[i]))
        return self.waiting.pop(i)

    def add(self, req: Request) -> bool:
        """Admit or reject (FINISH_REJECTED)."""
        plen = req.prompt_len
        cap = self.buffer_len - plen
        if self.page_size and self.total_pages:
            cap = min(cap, self.total_pages * self.page_size - plen)
        if plen < 1 or plen > self.buffer_len - 1 or cap < 1 \
                or req.max_new_tokens > cap:
            req.finish_reason = FINISH_REJECTED
            return False
        if req._sched_seq is None:
            req._sched_seq = self._seq
            self._seq += 1
        self.waiting.append(req)
        return True

    def requeue(self, req: Request) -> None:
        """Put an admitted request back (its arrival order is kept)."""
        self.waiting.append(req)

    def schedule(self, running, free_slots, *,
                 token_budget: Optional[int] = None) -> SchedulerOutput:
        """Emit one step's worth of work.

        ``running`` is ``[(slot, Request, prefill_done)]`` for occupied
        slots (``prefill_done == prompt_len`` means the slot decodes);
        ``free_slots`` are unoccupied slot ids. Decodes are always
        scheduled; the rest of ``token_budget`` is split across prompt
        chunks of at most ``chunk_size`` tokens, and a mid-prefill slot
        always progresses by at least one token.
        """
        chunk = self.chunk_size
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
            take = min(chunk, req.prompt_len, budget)
            chunks.append(ChunkTask(slot, req, 0, take,
                                    take >= req.prompt_len))
            budget -= take
        n_tok = len(decodes) + sum(c.length for c in chunks)
        return SchedulerOutput(decode_slots=tuple(decodes),
                               chunks=tuple(chunks),
                               n_scheduled_tokens=n_tok)
