"""Design-space exploration (port of ``repro.hwmodel.dse``; paper §5.3).

The paper's DSE exhaustively searches <M, T_R, T_P, T_C> under DSP/BRAM
constraints. The analogue here searches:
  - the OVSF execution path per workload (materialize / fused / spectral),
  - kernel block shapes (bm, bk, bn, bj) under the on-chip memory constraint
    (``hwmodel.tile_balance``),
  - and, at the sharding level, the TP degree for the given device count.

All candidates are scored with the analytical model (``perf_model``);
designs violating the resource constraints (on-chip footprint, HBM
capacity) are flagged infeasible, exactly as in the paper.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

from repro_torch.hwmodel import perf_model as pm
from repro_torch.hwmodel import tile_balance as tb


@dataclasses.dataclass
class DesignPoint:
    exec_path: str
    tp: int
    blocks: tb.BalanceChoice
    total_s: float
    feasible: bool
    hbm_per_device: float


def hbm_per_device(cfg, n_devices: int, tp: int, *, train: bool,
                   cache_bytes: float = 0.0) -> float:
    """First-order parameter+state footprint per device (FSDP over data)."""
    from repro_torch.models import registry as R
    pbytes = sum(t.numel() * t.element_size()
                 for t in R.leaves(R.model_init_specs(cfg)))
    per_dev = pbytes / n_devices
    if train:
        per_dev *= 1 + 2 * 2  # + m, v in fp32 (params assumed bf16)
    return per_dev + cache_bytes / n_devices


def explore(cfg, shape, *, hw: pm.HW = pm.V5E, n_devices: int = 256,
            tps: Sequence[int] = (8, 16, 32),
            paths: Sequence[str] = ("materialize", "fused", "spectral"),
            cache_bytes: float = 0.0) -> list[DesignPoint]:
    """Rank design points by modeled step time; infeasible points flagged."""
    out = []
    train = shape.kind == "train"
    for tp, path in itertools.product(tps, paths):
        if n_devices % tp:
            continue
        c = cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, exec_path=path)) \
            if cfg.ovsf.enable else cfg
        layers = pm.model_layers(c, shape, n_devices=n_devices, tp=tp)
        if not layers:
            continue
        t = pm.model_timing(layers, hw).total_s
        l0 = max(layers, key=lambda l: l.M * l.d_in * l.d_out)
        blocks = tb.balance_blocks(l0.M, l0.d_in, l0.d_out,
                                   vmem_limit=int(hw.vmem_bytes * 0.75))
        mem = hbm_per_device(c, n_devices, tp, train=train,
                             cache_bytes=cache_bytes)
        out.append(DesignPoint(path, tp, blocks, t, mem <= hw.hbm_bytes, mem))
    out.sort(key=lambda d: (not d.feasible, d.total_s))
    return out
