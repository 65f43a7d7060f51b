"""Request-level serving API (copy of ``repro.serving.api``'s request types).

The port keeps its own copy: it imports nothing of ``repro``. A preempted
request carries no PRNG state, because a sampled draw is a pure function of
``(seed, tokens emitted)`` (``serving.core``). ``Request.model`` is the
multi-model gateway's routing target (``serving.gateway``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

__all__ = [
    "SamplingParams", "Request", "RequestOutput",
    "FINISH_LENGTH", "FINISH_EOS", "FINISH_REJECTED",
    "FINISH_TIMEOUT", "FINISH_SHED", "FINISH_ERROR", "FINISH_PREEMPTED",
    "FINISH_EVICTED", "FINISH_CANCELLED",
]

FINISH_LENGTH = "length"        # hit max_new_tokens
FINISH_EOS = "eos"              # sampled the eos token
FINISH_REJECTED = "rejected"    # failed admission (would overflow the cache)
FINISH_TIMEOUT = "timeout"      # deadline_s expired (queued or mid-flight)
FINISH_SHED = "shed"            # load-shed from a full bounded waiting queue
FINISH_ERROR = "error"          # quarantined: non-finite emitted logits
FINISH_PREEMPTED = "preempted"  # preempted and could not be re-admitted
                                # (bounded queue full of more urgent
                                # work); otherwise preemption is transient
FINISH_EVICTED = "evicted"      # gateway: target model's weights evicted
FINISH_CANCELLED = "cancelled"  # caller abandoned the request


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    ``temperature <= 0`` means greedy argmax (top_k/seed are then unused).
    ``top_k == 0`` means no top-k filtering. The draw of the request's t-th
    emitted token is a pure function of ``(seed, t)`` (``serving.core``), so
    a sampled stream depends neither on batch composition or slot nor on
    preemption, watchdog recovery or a process restart.
    """
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


@dataclasses.dataclass
class Request:
    """One generation request. Mutable fields track in-flight progress.

    ``priority`` orders the waiting queue (higher first, FCFS within a
    level) and arms preemption under ``admission="preempt"``: a waiting
    request of strictly higher priority may evict the least urgent running
    slot (recomputed, never lost). ``deadline_s`` is a wall-clock budget
    from submission; an expired request, queued or running, finishes as
    ``FINISH_TIMEOUT`` with the tokens it has. ``idempotency_key`` is a
    client's retry-dedup key, journaled with the admission
    (``serving.journal``). ``on_finish`` fires exactly once with the final
    :class:`RequestOutput`, for every terminal reason.
    """
    rid: int
    prompt: np.ndarray                  # (S,) int32 token ids
    max_new_tokens: int = 16
    sampling: SamplingParams = GREEDY
    # gateway routing target (registry model name); None = single-model
    # engines, which ignore it
    model: Optional[str] = None
    # called as stream(rid, token) the moment each token is committed
    stream: Optional[Callable[[int, int], None]] = None
    priority: int = 0                   # higher = more urgent
    deadline_s: Optional[float] = None  # seconds after t_submit
    idempotency_key: Optional[str] = None
    on_finish: Optional[Callable[["RequestOutput"], None]] = None
    out_tokens: list = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    t_submit: float = 0.0
    token_times: list = dataclasses.field(default_factory=list)
    # -- preemption/recompute state (engine-managed) ------------------------
    preemptions: int = 0                # times this request lost its slot
    # original prompt length; ``prompt`` is rewritten to prompt + generated
    # tokens on preemption so chunked prefill recomputes the context
    prompt_len_orig: Optional[int] = None
    _notified: bool = False             # on_finish fired (exactly-once guard)
    # scheduler-managed FCFS sequence number; survives requeue, so a
    # preempted request resumes ahead of younger same-priority waiters
    _sched_seq: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def expired(self) -> bool:
        """Deadline elapsed (False with no deadline or before submission)."""
        return (self.deadline_s is not None and self.t_submit > 0.0
                and time.perf_counter() - self.t_submit > self.deadline_s)

    def emit(self, tok: int) -> None:
        self.token_times.append(time.perf_counter())
        self.out_tokens.append(tok)
        if self.stream is not None:
            self.stream(self.rid, tok)

    def output(self) -> "RequestOutput":
        ttft = (self.token_times[0] - self.t_submit
                if self.token_times and self.t_submit else None)
        itls = tuple(b - a for a, b in zip(self.token_times,
                                           self.token_times[1:]))
        plen = (self.prompt_len_orig if self.prompt_len_orig is not None
                else self.prompt_len)
        return RequestOutput(rid=self.rid, prompt_len=plen,
                             tokens=tuple(self.out_tokens),
                             finish_reason=self.finish_reason,
                             ttft_s=ttft, itls_s=itls,
                             preemptions=self.preemptions)


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Immutable result of a finished (or rejected) request."""
    rid: int
    prompt_len: int
    tokens: tuple
    finish_reason: Optional[str]
    ttft_s: Optional[float] = None      # submission -> first committed token
    itls_s: tuple = ()                  # inter-token latencies
    preemptions: int = 0                # times preempted and recomputed

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)
