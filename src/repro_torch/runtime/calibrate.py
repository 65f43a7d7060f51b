"""Measured-vs-modeled calibration: feed measured times back to the mapper
(port of ``repro.runtime.calibrate``).

The hardware-aware layer mapper (``runtime.mapper``) trusts the analytical
initiation-interval model in ``hwmodel.perf_model``. The paper's autotune
loop (§6.2) — and Petrica et al.'s memory-efficient dataflow argument — both
feed *measured* occupancy back into the mapping decision instead. This
module closes that loop for the serving engine:

1. every ``EngineCore.step`` reports per-step wall time (``StepOutput``);
2. :func:`attribute_step` splits a pure-decode step's wall time across the
   plan's weight-type entries in proportion to their modeled II (the
   reference's attribution, kept as it is: approximate, and uniform after
   normalisation by construction);
3. :class:`CalibrationTable` accumulates measured/modeled ratios per
   ``(layer, path, hw)`` and exposes :meth:`factor`, a **relative**
   correction — each entry's mean ratio normalised by the global mean ratio
   for that hw target. Normalising matters: wall times measured on the host
   or the card against data-sheet model constants carry a huge *uniform*
   skew,
   and a uniform factor applied only to executed paths would flip every
   layer to its never-measured alternative. Only per-layer deviations from
   the model survive normalisation;
4. ``mapper.classify_gemm(..., calibration=table)`` multiplies each
   candidate path's modeled II by its factor, so the next ``plan_model``
   call picks paths under the corrected model.

Tables serialise to JSON so a calibration run (``launch.serve --calibrate``)
can feed later planning runs. Per-layer samples measured directly (one
time per (layer, path), as ``chip_smoke.py`` takes for the CNN convs) go in
through :meth:`CalibrationTable.record`; every candidate path of a layer
needs one, since an unmeasured key keeps factor 1.0.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional


def _key(name: str, path: str, hw: str) -> str:
    return f"{name}|{path}|{hw}"


@dataclasses.dataclass
class _Acc:
    """Accumulated log-ratio samples for one (layer, path, hw) key."""
    sum_log: float = 0.0
    n: int = 0

    def add(self, ratio: float) -> None:
        self.sum_log += math.log(max(ratio, 1e-12))
        self.n += 1

    @property
    def mean(self) -> float:
        """Geometric mean ratio (robust to the multiplicative noise of wall
        timing; one slow outlier step cannot dominate)."""
        return math.exp(self.sum_log / self.n) if self.n else 1.0


class CalibrationTable:
    """Per-(layer, path, hw) measured/modeled II correction factors."""

    def __init__(self):
        self._acc: dict[str, _Acc] = {}

    def __len__(self) -> int:
        return len(self._acc)

    def record(self, name: str, path: str, hw: str,
               measured_s: float, modeled_s: float) -> None:
        """Add one sample: a measured wall time against its modeled II."""
        if measured_s <= 0.0 or modeled_s <= 0.0:
            return
        self._acc.setdefault(_key(name, path, hw),
                             _Acc()).add(measured_s / modeled_s)

    def raw_ratio(self, name: str, path: str, hw: str) -> Optional[float]:
        acc = self._acc.get(_key(name, path, hw))
        return acc.mean if acc is not None else None

    def _global_mean(self, hw: str) -> float:
        tot, n = 0.0, 0
        for k, acc in self._acc.items():
            if k.endswith(f"|{hw}") and acc.n:
                tot += acc.sum_log / acc.n
                n += 1
        return math.exp(tot / n) if n else 1.0

    def factor(self, name: str, path: str, hw: str) -> float:
        """Relative correction for one candidate: mean measured/modeled
        ratio normalised by the hw target's global mean ratio (1.0 when
        unmeasured). > 1 means the layer ran slower than the model predicts
        *relative to the rest of the model* — the mapper should penalise it.
        """
        acc = self._acc.get(_key(name, path, hw))
        if acc is None or not acc.n:
            return 1.0
        return acc.mean / self._global_mean(hw)

    def factors(self, hw: str) -> dict[str, float]:
        """All normalised factors for one hw target, keyed 'name|path'."""
        out = {}
        for k, acc in self._acc.items():
            if k.endswith(f"|{hw}") and acc.n:
                name, path, _ = k.split("|")
                out[f"{name}|{path}"] = acc.mean / self._global_mean(hw)
        return out

    # -- persistence --------------------------------------------------------

    def to_json(self) -> dict:
        return {k: {"sum_log": a.sum_log, "n": a.n}
                for k, a in self._acc.items()}

    @classmethod
    def from_json(cls, data: dict) -> "CalibrationTable":
        t = cls()
        for k, v in data.items():
            t._acc[k] = _Acc(sum_log=float(v["sum_log"]), n=int(v["n"]))
        return t

    def save(self, path: str) -> None:
        # Crash-safe: a table feeding later planning runs must never be
        # half-written (tmp + fsync + rename, see checkpoint.ckpt).
        from repro_torch.checkpoint.ckpt import atomic_write_json
        atomic_write_json(path, self.to_json(), indent=2)

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


def attribute_step(plan, wall_s: float) -> list[tuple[str, str, float, float]]:
    """Split one decode step's wall time across the plan's entries.

    Returns ``[(name, path, measured_s, modeled_s)]`` with the measured
    share proportional to each entry's modeled II: the finest attribution
    a step's one wall time allows.
    Per-layer *relative* error therefore only accumulates through repeated
    samples under varying batch mixes; a single sample calibrates the
    whole-model scale. Entries with no modeled II are skipped.
    """
    entries = [(n, lp) for n, lp in getattr(plan, "entries", ())
               if lp.ii_s > 0.0]
    total = sum(lp.ii_s for _n, lp in entries)
    if not entries or total <= 0.0 or wall_s <= 0.0:
        return []
    return [(n, lp.path, wall_s * (lp.ii_s / total), lp.ii_s)
            for n, lp in entries]


def update_from_step(table: CalibrationTable, plan, wall_s: float,
                     hw: str) -> int:
    """Record one decode step's attribution into ``table``; returns the
    number of samples recorded."""
    samples = attribute_step(plan, wall_s)
    for name, path, measured, modeled in samples:
        table.record(name, path, hw, measured, modeled)
    return len(samples)
