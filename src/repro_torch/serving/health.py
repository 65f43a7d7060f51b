"""Fleet-level health primitives: replica state machines + circuit breakers
(copy of ``repro.serving.health``: pure Python, no device).

Two small, dependency-free state machines that the multi-model gateway
composes into fleet fault tolerance:

* :class:`ReplicaHealth` — HEALTHY -> DEGRADED -> DEAD per engine replica,
  driven by *incident points* the gateway books from each replica's
  ``EngineStats`` deltas after every step (watchdog recoveries, NaN
  quarantines; stalls are recorded but weigh 0 by default because a stall
  already books the recovery that follows it). DEGRADED replicas keep
  serving their in-flight work but lose new-admission priority; a DEAD
  replica is drained and its requests fail over to survivors via the
  engine's preempt-and-recompute path, so the resumed streams stay
  token-identical. Clean steps can forgive old incidents
  (``forgive_after``) so one bad burst does not condemn a replica forever.

* :class:`CircuitBreaker` — CLOSED -> OPEN -> HALF_OPEN per model at the
  HTTP front door. ``trip_after`` consecutive FINISH_ERROR completions
  open the breaker: the model answers 503 + ``Retry-After`` instead of
  queueing doomed work. After ``cooldown_s`` the breaker half-opens and
  admits ``probes`` trial requests; one success re-closes it, one failure
  re-opens with a fresh cooldown. The clock is injectable so tests drive
  the whole cycle without sleeping.

Neither class knows about engines, HTTP, or each other — the gateway wires
stats deltas in and routing decisions out.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Mapping, Optional

__all__ = [
    "HEALTHY", "DEGRADED", "DEAD",
    "CLOSED", "OPEN", "HALF_OPEN",
    "HealthPolicy", "ReplicaHealth", "CircuitBreaker",
]

# -- replica states ---------------------------------------------------------

HEALTHY = "healthy"      # full service: admissions + in-flight
DEGRADED = "degraded"    # serving, but new admissions prefer healthy peers
DEAD = "dead"            # drained: in-flight work failed over to survivors

_DEFAULT_WEIGHTS = {
    "recovery": 1,       # watchdog core rebuild (step exception OR stall —
                         # the stall path books its recovery too)
    "stall": 0,          # recorded for observability; weighted by the
                         # recovery it triggers, not double-counted
    "quarantine": 1,     # NaN-poisoned request quarantined (FINISH_ERROR)
    "fault": 1,          # explicitly injected / operator-declared incident
}


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Thresholds mapping accumulated incident points to a replica state.

    ``degraded_after``/``dead_after`` are inclusive point thresholds.
    ``forgive_after > 0`` retires one incident point every N consecutive
    clean steps — sustained health earns the replica its way back from
    DEGRADED (DEAD is terminal: the replica was already drained).
    """
    degraded_after: int = 1
    dead_after: int = 3
    forgive_after: int = 0
    weights: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: dict(_DEFAULT_WEIGHTS))

    def __post_init__(self):
        if self.degraded_after < 1 or self.dead_after < self.degraded_after:
            raise ValueError(
                f"need 1 <= degraded_after <= dead_after, got "
                f"degraded_after={self.degraded_after}, "
                f"dead_after={self.dead_after}")


class ReplicaHealth:
    """Incident accumulator for one engine replica."""

    def __init__(self, policy: Optional[HealthPolicy] = None):
        self.policy = policy or HealthPolicy()
        self.points = 0
        self.counts: dict = {}       # raw per-kind event counts (all kinds)
        self._clean_streak = 0
        self._dead = False

    @property
    def state(self) -> str:
        if self._dead or self.points >= self.policy.dead_after:
            self._dead = True         # DEAD is sticky: the drain already ran
            return DEAD
        if self.points >= self.policy.degraded_after:
            return DEGRADED
        return HEALTHY

    @property
    def alive(self) -> bool:
        return self.state != DEAD

    def record(self, kind: str, n: int = 1) -> str:
        """Book ``n`` incidents of ``kind``; returns the resulting state."""
        if n > 0:
            self.counts[kind] = self.counts.get(kind, 0) + n
            self.points += self.policy.weights.get(kind, 1) * n
            self._clean_streak = 0
        return self.state

    def ok_step(self) -> str:
        """Book one incident-free step (drives ``forgive_after`` decay)."""
        f = self.policy.forgive_after
        if f > 0 and self.points > 0 and not self._dead:
            self._clean_streak += 1
            if self._clean_streak >= f:
                self._clean_streak = 0
                self.points -= 1
        return self.state


# -- per-model circuit breaker ----------------------------------------------

CLOSED = "closed"        # normal admission
OPEN = "open"            # refusing: 503 + Retry-After until cooldown
HALF_OPEN = "half_open"  # admitting up to ``probes`` trial requests


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    ``trip_after <= 0`` disables the breaker entirely (``allow`` is always
    True). ``clock`` defaults to ``time.monotonic``; tests inject a fake.
    """

    def __init__(self, trip_after: int = 3, cooldown_s: float = 5.0,
                 probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if trip_after > 0 and (cooldown_s <= 0.0 or probes < 1):
            raise ValueError("breaker needs cooldown_s > 0 and probes >= 1")
        self.trip_after = trip_after
        self.cooldown_s = cooldown_s
        self.probes = probes
        self._clock = clock
        self.state = CLOSED
        self.failures = 0            # consecutive FINISH_ERROR streak
        self.trips = 0               # times the breaker opened
        self._opened_at = 0.0
        self._probes_inflight = 0

    @property
    def enabled(self) -> bool:
        return self.trip_after > 0

    def _maybe_half_open(self) -> None:
        if (self.state == OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self.state = HALF_OPEN
            self._probes_inflight = 0

    def allow(self) -> bool:
        """May one more request be admitted for this model right now?"""
        if not self.enabled or self.state == CLOSED:
            return True
        self._maybe_half_open()
        if self.state == HALF_OPEN and self._probes_inflight < self.probes:
            self._probes_inflight += 1
            return True
        return False

    def retry_after_s(self) -> int:
        """Whole seconds for the ``Retry-After`` header (>= 1)."""
        remaining = self.cooldown_s - (self._clock() - self._opened_at)
        return max(1, int(math.ceil(remaining))) if remaining > 0 else 1

    def _trip(self) -> None:
        self.state = OPEN
        self.trips += 1
        self.failures = 0
        self._opened_at = self._clock()
        self._probes_inflight = 0

    def record_success(self) -> None:
        self.failures = 0
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self._probes_inflight = 0

    def record_failure(self) -> None:
        if not self.enabled:
            return
        if self.state == HALF_OPEN:   # probe failed: straight back to OPEN
            self._trip()
            return
        self.failures += 1
        if self.state == CLOSED and self.failures >= self.trip_after:
            self._trip()
