"""Hardware-aware tuning of OVSF ratios (port of ``repro.hwmodel.autotune``;
paper §6.2, Table 1 / Fig 7).

Start from the most lightweight ratio set (OVSF25-analogue), classify every
layer's bound {IFM, OFM, C, W}, and iteratively RAISE rho on layers where
weight generation is not the bound: better weight approximation (higher
accuracy) at unchanged throughput. Ratios only ever increase, so accuracy is
lower-bounded by the starting point (paper's feature 2).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.hwmodel import perf_model as pm

RHO_LADDER = (0.125, 0.25, 0.333, 0.4, 0.5, 0.667, 0.8, 1.0)


@dataclasses.dataclass
class TuneResult:
    rhos: dict                 # layer name -> final rho
    bounds: dict               # layer name -> bound class (at final rhos)
    baseline_total_s: float
    tuned_total_s: float
    steps: list                # (layer, old_rho, new_rho) log


def _with_rho(layer: pm.GemmLayer, rho: float) -> pm.GemmLayer:
    # rho=1.0 still means "generated from all L0 codes" for an OVSF layer
    # (the paper's uniform-1.0 row), not a dense fallback.
    return dataclasses.replace(layer, rho=min(rho, 1.0))


def autotune_rhos(layers: Sequence[pm.GemmLayer], hw: pm.HW = pm.V5E,
                  slack: float = 1.0) -> TuneResult:
    """Raise each OVSF layer's rho while its II is not W(gen)-bound.

    ``slack`` < 1.0 additionally requires t_wgen <= slack * II so the
    generation stage keeps headroom (useful when overlap is imperfect).
    """
    layers = [dataclasses.replace(l) for l in layers]
    base = pm.model_timing(layers, hw)
    log = []
    for i, l in enumerate(layers):
        if not l.ovsf:
            continue
        cur = l.rho
        for rho in RHO_LADDER:
            if rho <= cur:
                continue
            cand = _with_rho(l, rho)
            t = pm.layer_timing(cand, hw)
            ii_others = max(t.t_mem_in + t.t_mem_w, t.t_eng, t.t_mem_out)
            # accept iff generation is hidden: wgen below the other stages
            if t.t_wgen <= slack * ii_others and t.bound != "W":
                if t.ii <= pm.layer_timing(layers[i], hw).ii * (1 + 1e-9):
                    log.append((l.name, cur, rho))
                    layers[i] = cand
                    cur = rho
                else:
                    break
            else:
                break
    tuned = pm.model_timing(layers, hw)
    return TuneResult(
        rhos={l.name: (l.rho if l.ovsf else 1.0) for l in layers},
        bounds=tuned.bounds,
        baseline_total_s=base.total_s,
        tuned_total_s=tuned.total_s,
        steps=log,
    )
