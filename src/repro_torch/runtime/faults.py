"""Deterministic, seed-driven fault injection for serving and training (copy
of ``repro.runtime.faults``).

One :class:`FaultPlan` describes every fault a run should experience, as a
pure function of the step index: two runs with the same plan see the same
faults, so "the post-recovery streams equal the fault-free run" is a
testable property.

Kinds, each fired at one ``step`` (optionally recurring ``every`` steps
after it) or with per-step probability ``p`` from a counter-based RNG
seeded by ``(plan.seed, index, step)``:

* ``nan``   poison the emitted logits of slot ``slot`` (the step's
            ``isfinite`` row must quarantine exactly that request);
* ``fail``  raise :class:`InjectedFault` at the top of the step, before
            any device work (the engine watchdog rebuilds the core and
            recomputes every live slot);
* ``delay`` sleep ``delay_s`` inside the step (trips ``step_timeout_s``);
* ``die``   ``os._exit(DIE_EXIT_CODE)`` mid-step: a ``kill -9``; only the
            write-ahead journal (``serving.journal``) survives it;
* ``flip``  flip bit ``bit`` of alpha-bank leaf ``leaf`` in a model's
            RESIDENT registry bank; the gateway applies it at its own step
            counter (``serving.gateway``; the scrub must catch and repair
            it), engines ignore it, the single-engine launcher refuses it.

CLI syntax (``--inject`` on ``repro_torch.launch.serve`` and
``repro_torch.launch.gateway``)::

    nan:step=3            poison slot 0's logits at step 3
    nan:step=3,slot=1     ... slot 1
    nan:p=0.05            ... slot 0, 5% of steps (seed-driven)
    fail:step=7           raise at step 7
    fail:step=7,every=50  ... and every 50 steps after
    delay:step=5,s=0.2    sleep 200ms inside step 5
    die:step=5            os._exit the whole process at step 5
    flip:step=3,leaf=2,bit=17   gateway: flip bit 17 of bank leaf 2
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np

__all__ = ["Fault", "FaultPlan", "InjectedFault", "parse_fault",
           "DIE_EXIT_CODE"]

_KINDS = ("nan", "fail", "delay", "flip", "die")

#: Exit code of a ``die`` fault: distinctive, so the restart supervisor
#: tells an injected kill (restart and recover) from an organic failure.
DIE_EXIT_CODE = 86


class InjectedFault(RuntimeError):
    """Raised by a ``fail`` injector: a simulated step crash."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injector. Exactly one of ``step`` (>= 0) or ``p`` (> 0) arms it."""
    kind: str
    step: int = -1              # fire at this step index (-1: probabilistic)
    every: int = 0              # with step >= 0: recur every N steps after
    p: float = 0.0              # per-step firing probability (seed-driven)
    slot: int = 0               # nan: the slot whose logits are poisoned
    delay_s: float = 0.0        # delay: injected latency
    leaf: int = 0               # flip: alpha-bank leaf index
    bit: int = 0                # flip: bit offset within the leaf

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if (self.step < 0) == (self.p <= 0.0):
            raise ValueError(
                f"fault {self.kind!r} needs exactly one trigger: "
                f"step>=0 or p>0 (got step={self.step}, p={self.p})")
        if self.kind == "delay" and self.delay_s <= 0.0:
            raise ValueError("delay fault needs s > 0")

    def fires_at(self, step: int, seed: int, index: int) -> bool:
        """Pure function of (plan seed, fault index, step)."""
        if self.step >= 0:
            if step == self.step:
                return True
            return (self.every > 0 and step > self.step
                    and (step - self.step) % self.every == 0)
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, index, step]))
        return bool(rng.random() < self.p)


def parse_fault(spec: str) -> Fault:
    """Parse one ``--inject`` spec: ``kind:key=value,key=value``."""
    kind, _, rest = spec.partition(":")
    kw: dict = {}
    keys = {"step": ("step", int), "every": ("every", int),
            "p": ("p", float), "slot": ("slot", int),
            "s": ("delay_s", float),
            "leaf": ("leaf", int), "bit": ("bit", int)}
    for part in filter(None, rest.split(",")):
        k, _, v = part.partition("=")
        if k not in keys or not v:
            raise ValueError(f"bad fault spec {spec!r}: token {part!r} "
                             f"(expected key=value with key in {list(keys)})")
        field, cast = keys[k]
        kw[field] = cast(v)
    try:
        return Fault(kind=kind, **kw)
    except (ValueError, TypeError) as e:
        raise ValueError(f"bad fault spec {spec!r}: {e}") from e


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults over step indices."""
    faults: tuple = ()
    seed: int = 0

    @staticmethod
    def parse(specs: Iterable[str], seed: int = 0) -> "FaultPlan":
        return FaultPlan(tuple(parse_fault(s) for s in specs), seed=seed)

    def __bool__(self) -> bool:
        return bool(self.faults)

    def at(self, step: int) -> tuple:
        """Every fault firing at ``step``."""
        return tuple(f for i, f in enumerate(self.faults)
                     if f.fires_at(step, self.seed, i))

    def poison_row(self, step: int, n_slots: int) -> Optional[np.ndarray]:
        """(B,) float32 additive logits poison for ``step``: NaN at each
        firing ``nan`` fault's slot, else 0. None when nothing fires."""
        rows = [f.slot for f in self.at(step)
                if f.kind == "nan" and 0 <= f.slot < n_slots]
        if not rows:
            return None
        poison = np.zeros(n_slots, np.float32)
        poison[rows] = np.nan
        return poison

    def raise_or_delay(self, step: int) -> None:
        """Apply the ``fail``/``delay``/``die`` faults of ``step`` (``nan``
        is ``poison_row``'s). ``delay`` sleeps first, so a step can be both
        slow and fatal; ``die`` hard-kills the process (``os._exit``:
        nothing flushes, nothing catches it)."""
        fired = self.at(step)
        for f in fired:
            if f.kind == "delay":
                time.sleep(f.delay_s)
        for f in fired:
            if f.kind == "die":
                os._exit(DIE_EXIT_CODE)
        for f in fired:
            if f.kind == "fail":
                raise InjectedFault(f"injected step failure at step {step}")

    def failure_injector(self):
        """Adapt onto ``runtime.supervisor.run(failure_injector=...)``: a
        callable(step) that sleeps for ``delay`` faults (straggler watchdog
        fodder) and raises on ``fail`` faults. The supervisor re-visits a
        failed step after restore-and-replay, so each (fault, step) fires at
        most once per injector: the node dies once, the replay succeeds.
        ``nan`` (serving), ``flip`` (gateway) and ``die`` (serving) faults
        are ignored."""
        fired: set = set()

        def injector(step: int) -> None:
            live = [(i, f) for i, f in enumerate(self.faults)
                    if f.kind not in ("nan", "flip", "die")
                    and (i, step) not in fired
                    and f.fires_at(step, self.seed, i)]
            for i, f in live:
                fired.add((i, step))
                if f.kind == "delay":
                    time.sleep(f.delay_s)
            for _i, f in live:
                if f.kind == "fail":
                    raise InjectedFault(
                        f"injected step failure at step {step}")

        return injector
