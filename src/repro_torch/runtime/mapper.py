"""Hardware-aware layer mapper: per-layer OVSF execution-path dispatch (port
of ``repro.runtime.mapper``, trimmed to the LM and CNN planners).

Given a layer shape, its OVSF ratio and a hardware target, the mapper picks
how the weights-generation mechanism runs for that layer:

  ``fused``        generate each weight tile inside the GEMM (the CUDA
                   ``ovsf_gemm`` on the card);
  ``materialize``  generate dense W, then one GEMM (the CUDA
                   ``ovsf_decompress`` for monolithic codes; segmented codes
                   and quantised alphas run on the CPU only);
  ``spectral``     the activation-transform identity (opt-in via ``paths``;
                   the CUDA ``fwht`` for monolithic codes; segmented codes
                   run on the CPU only).

Decisions are pure functions of (layer shape, rho, HW): the same inputs give
the same plan as the reference, so plans are frozen dataclasses of tuples
and ride inside a hashable ``ModelConfig``. Block sizes and the cache policy
are recorded as the reference computes them; the CUDA ``ovsf_gemm`` tiles by
its own kernels' plans (``kernels.ovsf_gemm.tc_plan`` for bf16 activations
over segmented codes, ``tiling`` otherwise) and the port has no decompress
cache yet. The ``h100``
target's costs are data-sheet peaks fed to the reference's TPU pipeline
model; ``calibration=`` (a ``runtime.calibrate.CalibrationTable``) corrects
them with measured times, as the reference does: each candidate's modeled
II is multiplied by the table's relative factor before the minimum is
taken. The engine plans the LM layers (all segmented) on the card with
``paths=("fused",)``. ``plan_cnn`` plans the CNNs' im2col GEMMs (monolithic
codes), every path of which has a kernel on the card; like the reference's
it takes no table: a calibrated CNN plan is built from ``classify_gemm``
per conv (``chip_smoke.py`` does so from per-conv times on the card).
``suggest_rhos`` runs the rho autotuner (``hwmodel.autotune``) on the
workload the mapper plans.
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
                  alpha_dtype: str = "",
                  calibration=None) -> LayerPlan:
    """Map one OVSF GEMM y[M, d_out] = x[M, d_in] @ W(alphas) to a plan:
    the candidate path of least modeled II (first listed wins ties), then
    the block search over the chosen path's consumer GEMM. ``hw`` is an
    ``pm.HW`` or a registered target name; ``alpha_dtype`` models the
    quantised alpha stream. ``calibration`` (a
    ``runtime.calibrate.CalibrationTable``) multiplies each candidate's
    modeled II by its relative factor for ``(name, path, hw.name)`` before
    the minimum (1.0 for an unmeasured candidate); the plan's ``ii_s`` is
    the corrected one."""
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
        if calibration is not None:
            ii *= calibration.factor(name, path, hw.name)
        if ii < best_ii:
            best_path, best_ii, best_bound = path, ii, bound
    if best_path is None:
        raise RuntimeError(
            f"mapper: no viable execution path for layer {name!r} "
            f"(candidates considered: {list(paths)}) — every candidate "
            f"produced a non-finite modeled II; check the perf model / "
            f"calibration factors for hw={hw.name!r}")

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

# perf_model workload names -> the weight-type names the model code passes
# to ``linear_apply`` (``models.ssm`` registers its projections under the
# ``mlp`` OVSF target group as ``mlp_in`` / ``mlp_out``); without them the
# Mamba projections would get no plan entry
_WTYPE_ALIASES = {"ssm_in": "mlp_in", "ssm_out": "mlp_out"}


def plan_model(cfg, shape, *, hw=pm.V5E, n_devices: int = 1,
               tp: int = 1, paths: Sequence[str] = DEFAULT_PATHS,
               weight_reuse: Optional[int] = None,
               calibration=None) -> ExecutionPlan:
    """An ExecutionPlan for an LM-family ModelConfig (dense, MoE, SSM,
    hybrid, encoder-decoder, VLM) under a workload shape: the config's GEMMs
    (``pm.model_layers``) collapse to one plan per weight type, each from
    ``classify_gemm`` (``calibration`` threads a measured-vs-modeled table
    into every one). The type is the
    name cut at its first ``x``, as in the reference: that strips an
    expert workload's ``x{E}`` suffix but also cuts ``expert_*`` to ``e``,
    so the three expert types share one entry ``e`` (copied for parity);
    the Mamba workloads ``ssm_in`` / ``ssm_out`` take the names the model
    dispatches under (``_WTYPE_ALIASES``). ``weight_reuse`` defaults to
    1 for training and 256 otherwise (frozen serving params); the plan is
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
        wtype = _WTYPE_ALIASES.get(wtype, wtype)
        if wtype in seen:
            continue
        seen.add(wtype)
        entries.append((wtype, classify_gemm(
            l.M, l.d_in, l.d_out, l.rho, seg=l.seg, hw=hw, name=wtype,
            weight_reuse=weight_reuse, paths=paths,
            alpha_dtype=l.alpha_dtype, calibration=calibration)))
    return ExecutionPlan(tuple(entries), hw_label=hw.name)


def apply_plan(cfg, plan: ExecutionPlan):
    """A ModelConfig carrying the plan (read by ``layers.linear_apply``)."""
    return cfg.replace(exec_plan=plan)


def plan_and_apply(cfg, shape, **kw):
    return apply_plan(cfg, plan_model(cfg, shape, **kw))


def suggest_rhos(cfg, shape, *, hw=pm.V5E, n_devices: int = 1,
                 tp: int = 1, slack: float = 1.0):
    """Hardware-aware rho autotuning (paper §6.2) for the workload the
    mapper plans: raise each layer's OVSF ratio while generation stays off
    the critical path. Returns ``hwmodel.autotune.TuneResult``; feed its
    per-layer rhos back into ``OVSFConfig.rho_overrides`` and re-plan."""
    from repro_torch.hwmodel.autotune import autotune_rhos
    layers = pm.model_layers(cfg, shape, n_devices=n_devices, tp=tp)
    return autotune_rhos(layers, pm.resolve_hw(hw), slack=slack)


# ---------------------------------------------------------------------------
# CNN planning (im2col GEMMs through the same engine, paper §4.1)
# ---------------------------------------------------------------------------

def plan_cnn(cfg, *, batch: int = 1, hw=pm.V5E,
             paths: Sequence[str] = DEFAULT_PATHS,
             weight_reuse: int = 256) -> ExecutionPlan:
    """Plans for a ``models.cnn.CNNConfig``: each OVSF conv is an im2col GEMM
    with R = B*H'*W' rows and P = Cin*K*K contraction over monolithic codes
    (§4.1 mapping), keyed by the conv's name. Apply with
    ``cfg.replace(exec_plan=plan_cnn(cfg, ...))``."""
    hw = pm.resolve_hw(hw)
    entries: list[tuple[str, LayerPlan]] = []
    if cfg.depth == "squeezenet":
        specs = _squeezenet_convs(cfg)
    else:
        specs = _resnet_convs(cfg)
    for name, c_in, c_out, k, stride, rho, hw_cur in specs:
        if rho >= 1.0 or k < 3:
            continue
        M = batch * hw_cur * hw_cur
        fan_in = c_in * k * k
        entries.append((name, classify_gemm(
            M, fan_in, c_out, rho, seg=0, hw=hw, name=name,
            weight_reuse=weight_reuse, paths=paths)))
    return ExecutionPlan(tuple(entries), hw_label=hw.name)


def _resnet_convs(cfg):
    """(name, c_in, c_out, k, stride, rho, output side) per ResNet conv, as
    the reference reckons them: the side halves at every stride-2 conv,
    ``proj`` included, so each conv after a stage's first block is planned
    at half its real side (ROADMAP C; copied for equal plans)."""
    from repro_torch.models.cnn import _resnet_layers
    hw_cur = cfg.in_hw
    out = []
    for d in _resnet_layers(cfg):
        if d["name"] == "head":
            continue
        hw_cur = max(hw_cur // max(d["stride"], 1), 1)
        if d["name"] == "stem":
            hw_cur = max(hw_cur // 2, 1)          # stem maxpool
        out.append((d["name"], d["c_in"], d["c_out"], d["k"], d["stride"],
                    d["rho"], hw_cur))
    return out


def _squeezenet_convs(cfg):
    """(name, c_in, c_out, k, stride, rho, output side) of each fire's 3x3
    expand conv."""
    from repro_torch.models.cnn import _POOL_AFTER, _fire_widths
    hw_cur = max(cfg.in_hw // 4, 1)               # stem stride-2 + maxpool
    out = []
    for i, (sq, _e1, e3, stage) in enumerate(_fire_widths(cfg)):
        out.append((f"f{i}e3", sq, e3, 3, 1, cfg.block_rhos[stage], hw_cur))
        if i in _POOL_AFTER:
            hw_cur = max(hw_cur // 2, 1)
    return out
