"""Hardware-aware layer mapper: per-layer OVSF execution-path dispatch (port
of ``repro.runtime.mapper``, trimmed to the LM planner).

Given a layer shape, its OVSF ratio and a hardware target, the mapper picks
how the weights-generation mechanism runs for that layer:

  ``fused``        generate each weight tile inside the GEMM (the CUDA
                   ``ovsf_gemm`` on the card);
  ``materialize``  generate dense W, then one GEMM (plain tensor code, CPU
                   only in the port);
  ``spectral``     the activation-transform identity (opt-in via ``paths``;
                   CPU only in the port).

Decisions are pure functions of (layer shape, rho, HW): the same inputs give
the same plan as the reference, so plans are frozen dataclasses of tuples
and ride inside a hashable ``ModelConfig``. Block sizes and the cache policy
are recorded as the reference computes them; the CUDA ``ovsf_gemm`` keeps
its own tiling and the port has no decompress cache yet. The ``h100``
target's costs are data-sheet peaks fed to the reference's TPU pipeline
model, not calibrated against the port's measured kernels; the engine plans
on the card with ``paths=("fused",)``. The calibration loop
(``calibration=``), ``suggest_rhos`` and ``plan_cnn`` wait for the slices
that port them.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence

from repro_torch.hwmodel import perf_model as pm
from repro_torch.hwmodel import tile_balance as tb

DEFAULT_PATHS = ("materialize", "fused")
ALL_PATHS = ("materialize", "fused", "spectral")


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Execution plan for one OVSF GEMM: path + blocks + cache policy."""
    path: str                       # materialize | fused | spectral
    block_m: int = 128
    block_n: int = 128
    block_k: int = 128
    block_j: int = 128
    cache_weights: bool = False     # weight-stationary: decompress once, reuse
    cache_key: str = ""             # identity key for the decompress cache
    bound: str = "C"                # roofline bound class at decision time
    ii_s: float = 0.0               # modeled initiation interval (seconds)
    alpha_dtype: str = ""           # alpha storage the plan was modeled under


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Per-weight-type plans for a whole model (hashable)."""
    entries: tuple[tuple[str, LayerPlan], ...] = ()
    hw_label: str = "v5e"

    def plan_for(self, name: str) -> Optional[LayerPlan]:
        """Longest-substring match so 'mlp_up' resolves 'L3/mlp_up' etc."""
        best: Optional[LayerPlan] = None
        best_len = -1
        for pat, lp in self.entries:
            if pat == name:
                return lp
            if pat in name and len(pat) > best_len:
                best, best_len = lp, len(pat)
        return best

    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.entries)


def _candidate_ii(layer: pm.GemmLayer, path: str, hw: pm.HW, *,
                  weight_reuse: int, block_m: int) -> tuple[float, str]:
    """Modeled II + bound for one (layer, path) candidate: ``fused``
    regenerates each weight tile once per M-tile; ``materialize`` with the
    decompress cache amortises generation and the dense-W write over
    ``weight_reuse`` invocations."""
    l = dataclasses.replace(layer, exec_path=path)
    t = pm.layer_timing(l, hw)
    if path == "fused":
        m_tiles = max(math.ceil(layer.M / max(block_m, 1)), 1)
        t = dataclasses.replace(t, t_wgen=t.t_wgen * m_tiles)
    elif path == "materialize" and weight_reuse > 1:
        by = layer.dtype_bytes
        dense_read = layer.d_in * layer.d_out * by / hw.hbm_bw
        alpha_read = 0.0 if layer.alphas_resident else \
            layer.alpha_hbm_bytes / hw.hbm_bw
        t = dataclasses.replace(
            t,
            t_wgen=t.t_wgen / weight_reuse,
            t_mem_w=dense_read + alpha_read / weight_reuse)
    return t.ii, t.bound


def classify_gemm(M: int, d_in: int, d_out: int, rho: float, *,
                  seg: int = 16, hw=pm.V5E, name: str = "gemm",
                  weight_reuse: int = 1,
                  paths: Sequence[str] = DEFAULT_PATHS,
                  alphas_resident: bool = False,
                  alpha_dtype: str = "") -> LayerPlan:
    """Map one OVSF GEMM y[M, d_out] = x[M, d_in] @ W(alphas) to a plan:
    the candidate path of least modeled II (first listed wins ties), then
    the block search over the chosen path's consumer GEMM. ``hw`` is an
    ``pm.HW`` or a registered target name; ``alpha_dtype`` models the
    quantised alpha stream."""
    hw = pm.resolve_hw(hw)
    if seg and d_in % seg:
        seg = 0
    layer = pm.GemmLayer(name, M=M, d_in=d_in, d_out=d_out, rho=min(rho, 1.0),
                         ovsf=rho < 1.0, seg=seg,
                         alphas_resident=alphas_resident,
                         alpha_dtype=alpha_dtype if rho < 1.0 else "")
    if not layer.ovsf:
        blocks = tb.balance_blocks(M, d_in, d_out,
                                   vmem_limit=int(hw.vmem_bytes * 0.75))
        t = pm.layer_timing(layer, hw)
        return LayerPlan("materialize", block_m=blocks.bm, block_n=blocks.bn,
                         block_k=blocks.bk, cache_weights=False,
                         cache_key=name, bound=t.bound, ii_s=t.ii)

    best_path, best_ii, best_bound = None, float("inf"), "C"
    for path in paths:
        ii, bound = _candidate_ii(layer, path, hw, weight_reuse=weight_reuse,
                                  block_m=128)
        if ii < best_ii:
            best_path, best_ii, best_bound = path, ii, bound
    if best_path is None:
        raise RuntimeError(
            f"mapper: no viable execution path for layer {name!r} "
            f"(candidates considered: {list(paths)}) — every candidate "
            f"produced a non-finite modeled II for hw={hw.name!r}")

    # the spectral path contracts over J (= rho * d_in) instead of d_in
    k_eff = layer.j_total if best_path == "spectral" else d_in
    blocks = tb.balance_blocks(M, k_eff, d_out,
                               vmem_limit=int(hw.vmem_bytes * 0.75))
    bj = min(128, _ceil8(layer.j_total))
    bk = blocks.bk
    if seg and bk % seg:
        bk = max((bk // seg) * seg, seg)
    return LayerPlan(best_path, block_m=blocks.bm, block_n=blocks.bn,
                     block_k=bk, block_j=bj,
                     cache_weights=best_path == "materialize",
                     cache_key=name, bound=best_bound, ii_s=best_ii,
                     alpha_dtype=alpha_dtype)


def _ceil8(n: int) -> int:
    return ((max(n, 1) + 7) // 8) * 8


_LAYER_PREFIX = re.compile(r"^L\d+/")


def plan_model(cfg, shape, *, hw=pm.V5E, n_devices: int = 1,
               tp: int = 1, paths: Sequence[str] = DEFAULT_PATHS,
               weight_reuse: Optional[int] = None) -> ExecutionPlan:
    """An ExecutionPlan for a dense-family ModelConfig under a workload
    shape: the config's GEMMs (``pm.model_layers``) collapse to one plan per
    weight type, each from ``classify_gemm``. ``weight_reuse`` defaults to 1
    for training and 256 otherwise (frozen serving params); the plan is
    stamped with the target's name."""
    hw = pm.resolve_hw(hw)
    if weight_reuse is None:
        weight_reuse = 1 if shape.kind == "train" else 256
    layers = pm.model_layers(cfg, shape, n_devices=n_devices, tp=tp)
    entries: list[tuple[str, LayerPlan]] = []
    seen: set[str] = set()
    for l in layers:
        if not l.ovsf:
            continue
        wtype = _LAYER_PREFIX.sub("", l.name).split("x")[0]
        if wtype in seen:
            continue
        seen.add(wtype)
        entries.append((wtype, classify_gemm(
            l.M, l.d_in, l.d_out, l.rho, seg=l.seg, hw=hw, name=wtype,
            weight_reuse=weight_reuse, paths=paths,
            alpha_dtype=l.alpha_dtype)))
    return ExecutionPlan(tuple(entries), hw_label=hw.name)


def apply_plan(cfg, plan: ExecutionPlan):
    """A ModelConfig carrying the plan (read by ``layers.linear_apply``)."""
    return cfg.replace(exec_plan=plan)


def plan_and_apply(cfg, shape, **kw):
    return apply_plan(cfg, plan_model(cfg, shape, **kw))
