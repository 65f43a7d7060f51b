"""Request-level serving API (copy of ``repro.serving.api``'s request types).

The port keeps its own copy: it imports nothing of ``repro``. Fields that
only the not-yet-ported features read (gateway routing, deadlines,
idempotency keys, preemption resume state) wait for those slices.
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
FINISH_EVICTED = "evicted"      # gateway: target model's weights evicted
FINISH_CANCELLED = "cancelled"  # caller abandoned the request


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    ``temperature <= 0`` means greedy argmax (top_k/seed are then unused).
    ``top_k == 0`` means no top-k filtering. ``seed`` seeds the request's own
    ``torch.Generator``, which advances only on the request's emitted tokens,
    so a sampled stream does not depend on batch composition or slot.
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
    level). ``on_finish`` fires exactly once with the final
    :class:`RequestOutput`, for every terminal reason.
    """
    rid: int
    prompt: np.ndarray                  # (S,) int32 token ids
    max_new_tokens: int = 16
    sampling: SamplingParams = GREEDY
    # called as stream(rid, token) the moment each token is committed
    stream: Optional[Callable[[int, int], None]] = None
    priority: int = 0                   # higher = more urgent
    on_finish: Optional[Callable[["RequestOutput"], None]] = None
    out_tokens: list = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    t_submit: float = 0.0
    token_times: list = dataclasses.field(default_factory=list)
    _notified: bool = False             # on_finish fired (exactly-once guard)
    # scheduler-managed FCFS sequence number; survives requeue
    _sched_seq: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

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
        return RequestOutput(rid=self.rid, prompt_len=self.prompt_len,
                             tokens=tuple(self.out_tokens),
                             finish_reason=self.finish_reason,
                             ttft_s=ttft, itls_s=itls)


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Immutable result of a finished (or rejected) request."""
    rid: int
    prompt_len: int
    tokens: tuple
    finish_reason: Optional[str]
    ttft_s: Optional[float] = None      # submission -> first committed token
    itls_s: tuple = ()                  # inter-token latencies

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)
