"""Static tile balancer (port of ``repro.hwmodel.tile_balance``):
``balance_blocks`` picks the GEMM block shape that wastes the least of each
dimension to ceil-padding, utilisation(dim, block) = dim / (ceil(dim/block)
* block), under an on-chip footprint limit. The mapper records the chosen
blocks in its plans; the CUDA ``ovsf_gemm`` tiles by its own kernels' plans
(``kernels.ovsf_gemm.tc_plan`` and ``tiling``). ``input_selective_speedup``
is the paper's Eq. (7), the modelled gain of its input-selective PEs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

BLOCK_MENU = (64, 128, 192, 256, 384, 512)


def util(dim: int, block: int) -> float:
    return dim / (math.ceil(dim / block) * block)


def gemm_utilisation(M: int, K: int, N: int,
                     bm: int, bk: int, bn: int) -> float:
    return util(M, bm) * util(K, bk) * util(N, bn)


@dataclasses.dataclass
class BalanceChoice:
    bm: int
    bk: int
    bn: int
    util_naive: float      # with the default 128^3 blocks
    util_balanced: float


def balance_blocks(M: int, K: int, N: int, *,
                   menu: Sequence[int] = BLOCK_MENU,
                   vmem_limit: int = 96 * 2**20,
                   dtype_bytes: int = 2) -> BalanceChoice:
    """Pick (bm, bk, bn) maximising utilisation under the double-buffered
    footprint (bm*bk + bk*bn + bm*bn) * dtype_bytes * 2 <= vmem_limit; the
    128^3 default stands when nothing in the menu does better."""
    naive = gemm_utilisation(M, K, N, 128, 128, 128)
    best = (128, 128, 128, naive)
    for bm in menu:
        for bk in menu:
            for bn in menu:
                fp = (bm * bk + bk * bn + bm * bn) * dtype_bytes * 2
                if fp > vmem_limit:
                    continue
                u = gemm_utilisation(M, K, N, bm, bk, bn)
                if u > best[3] + 1e-12:
                    best = (bm, bk, bn, u)
    return BalanceChoice(best[0], best[1], best[2], naive, best[3])


def input_selective_speedup(T_R: int, T_C: int, C: int, P: int, T_P: int
                            ) -> float:
    """Paper Eq. (7) against the naive engine's runtime: the modelled gain of
    dynamic work-stealing for a layer with C output columns on a T_C-wide
    engine (1.0 where C >= T_C: no PE idles)."""
    if C >= T_C:
        return 1.0
    t_naive = T_R * math.ceil(P / T_P)
    rows_stolen = max(T_R * C - (T_C - C) * (C + 1), 0)
    t_sel = ((T_C - C) + math.ceil(rows_stolen / T_C)) * math.ceil(P / T_P)
    return t_naive / max(t_sel, 1)
