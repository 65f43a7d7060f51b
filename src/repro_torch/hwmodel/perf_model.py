"""The paper's analytical performance model (port of
``repro.hwmodel.perf_model``).

Each GEMM y[M, d_out] = x[M, d_in] @ W is a pipeline whose initiation
interval is the max of its stages (paper Eq. 5-8):

  t_mem   = (activation_in + alpha/weight + activation_out bytes) / HBM_bw
  t_wgen  = weights-generation FLOPs / peak  (0 for dense layers)
  t_eng   = consumer GEMM FLOPs / peak

and the bound class {IFM, OFM, W, C} is the largest stage. The arithmetic
is the reference's, unchanged: the same (shape, rho, target) gives the same
plan in both packages. Registered targets: the reference's four (v5e, v5p,
v6e, cpu) and ``h100``, the card the port runs on (data-sheet peaks, not
calibrated against the port's kernels; ``runtime.calibrate`` corrects
them from measured times). ``model_layers`` covers the dense and MoE
families, the ones the port serves; ``model_timing``, ``serve_step_timing``
and ``throughput`` sum its layers' IIs for the autotuner, the DSE and the
serving model.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from repro_torch.core.ovsf import next_pow2


@dataclasses.dataclass(frozen=True)
class HW:
    """One hardware target (default: TPU v5e), registered under ``name``."""
    peak_flops: float = 197e12        # bf16
    hbm_bw: float = 819e9             # B/s
    ici_bw: float = 50e9              # B/s per link
    hbm_bytes: float = 16e9
    vmem_bytes: float = 128 * 2**20
    vpu_flops: float = 197e12 / 8     # non-MXU elementwise throughput
    # Weights-generator unit. 0.0 -> generation timeshares the main unit;
    # > 0 -> a dedicated pipelined generator at that peak (paper Eq. 8).
    wgen_flops: float = 0.0
    name: str = "v5e"

    def scaled_bw(self, factor: float) -> "HW":
        return dataclasses.replace(self, hbm_bw=self.hbm_bw * factor)


V5E = HW()

# TPU v5p: 459 TFLOP/s bf16, 95 GB HBM2e at 2765 GB/s, 6 ICI links at
# ~100 GB/s each (Google Cloud "TPU v5p system architecture").
V5P = HW(name="v5p", peak_flops=459e12, hbm_bw=2765e9, ici_bw=100e9,
         hbm_bytes=95e9, vmem_bytes=128 * 2**20, vpu_flops=459e12 / 8)

# TPU v6e (Trillium): 918 TFLOP/s bf16, 32 GB HBM at 1640 GB/s, 4 ICI
# links totalling ~3.58 Tbps one-way (Google Cloud "TPU v6e" docs).
V6E = HW(name="v6e", peak_flops=918e12, hbm_bw=1640e9, ici_bw=112e9,
         hbm_bytes=32e9, vmem_bytes=128 * 2**20, vpu_flops=918e12 / 8)

# Generic dual-socket AVX-512 server: ~2 TFLOP/s f32 across cores,
# ~100 GB/s sustained DDR5, 32 MiB LLC standing in for VMEM.
CPU = HW(name="cpu", peak_flops=2e12, hbm_bw=100e9, ici_bw=0.0,
         hbm_bytes=256e9, vmem_bytes=32 * 2**20, vpu_flops=2e12)

# NVIDIA H100 SXM (data sheet, dense rates): 989 TFLOP/s bf16 on the tensor
# cores, 67 TFLOP/s fp32 outside them, 80 GB HBM3 at 3.35 TB/s, NVLink 450
# GB/s each way; the 227 KB of shared memory a block can use stands in for
# VMEM.
H100 = HW(name="h100", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
          hbm_bytes=80e9, vmem_bytes=232_448, vpu_flops=67e12)


# --- HW target registry (--hw v5e|v5p|v6e|cpu|h100) -------------------------

_HW_TARGETS: dict = {}


def register_hw(hw: HW) -> HW:
    """Register a target under ``hw.name`` (later wins, enabling overrides)."""
    _HW_TARGETS[hw.name] = hw
    return hw


for _hw in (V5E, V5P, V6E, CPU, H100):
    register_hw(_hw)


def hw_names() -> tuple:
    return tuple(_HW_TARGETS)


def hw_by_name(name: str) -> HW:
    try:
        return _HW_TARGETS[name]
    except KeyError:
        raise KeyError(f"unknown HW target {name!r}; "
                       f"registered: {sorted(_HW_TARGETS)}") from None


def resolve_hw(hw) -> HW:
    """Accept an ``HW`` instance or a registered target name."""
    if isinstance(hw, HW):
        return hw
    return hw_by_name(hw)


BoundClass = Literal["IFM", "OFM", "W", "C"]


def padding_efficiency(valid_tokens: float, batch_tokens: float) -> float:
    """Valid tokens / batch tokens (1.0 when the batch carried no padding
    or nothing ran)."""
    return valid_tokens / batch_tokens if batch_tokens else 1.0


@dataclasses.dataclass(frozen=True)
class GemmLayer:
    """One weight application: y[M, d_out] = x[M, d_in] @ W."""
    name: str
    M: int                  # rows (tokens) per device
    d_in: int
    d_out: int
    rho: float = 1.0        # OVSF ratio; >= 1.0 -> dense layer
    ovsf: bool = False
    exec_path: str = "materialize"   # materialize | fused | spectral
    seg: int = 16           # code segment length L0 (0 = monolithic)
    dtype_bytes: int = 2
    weight_resident: bool = False    # weights stay on chip across uses
    alphas_resident: bool = False    # alphas transferred upfront (Eq. 6)
    weight_reread: int = 1           # dense tiles re-read ceil(R/T_R) times
    # Storage of the streamed alphas: "" (dtype_bytes each), "int8" (1 B),
    # "int4" (0.5 B packed).
    alpha_dtype: str = ""
    kv_bytes: float = 0.0   # KV-cache bytes streamed per step (attn_o)
    m_valid: int = 0        # valid rows out of M (0 = all M rows)

    @property
    def valid_rows(self) -> int:
        return min(self.m_valid, self.M) if self.m_valid else self.M

    @property
    def alpha_itemsize(self) -> float:
        """Bytes per stored alpha coefficient."""
        return {"": float(self.dtype_bytes),
                "int8": 1.0, "int4": 0.5}[self.alpha_dtype]

    @property
    def alpha_hbm_bytes(self) -> float:
        """Alpha-stream bytes per step: coefficients + per-segment fp32
        scales."""
        b = self.j_total * self.d_out * self.alpha_itemsize
        if self.alpha_dtype:
            b += (self.j_total // self.n_keep) * 4.0
        return b

    @property
    def L(self) -> int:
        """Code length: L0 for the segmented (Alg. 1) form."""
        if self.seg and self.d_in % self.seg == 0:
            return self.seg
        return next_pow2(self.d_in)

    @property
    def n_keep(self) -> int:
        return max(1, int(round(self.rho * self.L)))

    @property
    def j_total(self) -> int:
        """Total alpha rows = stored weights rows."""
        if self.seg and self.d_in % self.seg == 0:
            return (self.d_in // self.seg) * self.n_keep
        return self.n_keep


@dataclasses.dataclass
class LayerTiming:
    t_mem_in: float
    t_mem_w: float
    t_mem_out: float
    t_wgen: float
    t_eng: float
    pipelined_gen: bool = True   # False: gen timeshares the engine unit
    t_wasted: float = 0.0        # II seconds attributable to padding rows

    @property
    def ii(self) -> float:
        # paper Eq. (8): concurrent {input-transfer}, weight-gen, engine, out.
        # When generation shares the compute unit it serialises into t_eng.
        if self.pipelined_gen:
            return max(self.t_mem_in + self.t_mem_w, self.t_wgen, self.t_eng,
                       self.t_mem_out)
        return max(self.t_mem_in + self.t_mem_w, self.t_wgen + self.t_eng,
                   self.t_mem_out)

    @property
    def bound(self) -> BoundClass:
        stages = {"IFM": self.t_mem_in + self.t_mem_w, "W": self.t_wgen,
                  "C": self.t_eng, "OFM": self.t_mem_out}
        return max(stages, key=stages.get)  # type: ignore[arg-type]


def layer_timing(layer: GemmLayer, hw: HW = V5E) -> LayerTiming:
    M, di, do = layer.M, layer.d_in, layer.d_out
    by = layer.dtype_bytes
    t_in = (M * di * by + layer.kv_bytes) / hw.hbm_bw
    t_out = M * do * by / hw.hbm_bw
    t_eng = 2.0 * M * di * do / hw.peak_flops
    t_w = 0.0
    t_gen = 0.0
    pipelined = True
    if not layer.ovsf:
        if not layer.weight_resident:
            t_w = layer.weight_reread * di * do * by / hw.hbm_bw
    else:
        J = layer.j_total                       # stored alpha rows (rho*d_in)
        gen_macs_per_w = layer.n_keep           # rho*L0 MACs per weight elem
        gen_peak = hw.wgen_flops or hw.peak_flops
        pipelined = hw.wgen_flops > 0
        if not layer.alphas_resident:
            t_w = layer.alpha_hbm_bytes / hw.hbm_bw  # alphas only cross HBM
        if layer.exec_path == "spectral":
            # per-seg FWHT on activations + rho-smaller GEMM
            t_gen = M * di * max(np.log2(max(layer.L, 2)), 1) / hw.vpu_flops
            t_eng = 2.0 * M * J * do / hw.peak_flops
            t_in = M * di * by / hw.hbm_bw
            pipelined = True
        elif layer.exec_path == "fused":
            t_gen = 2.0 * gen_macs_per_w * di * do / gen_peak
        else:  # materialize: dense W round-trips HBM (generate, write, reread)
            t_gen = 2.0 * gen_macs_per_w * di * do / gen_peak
            t_w += 2.0 * di * do * by / hw.hbm_bw
    t = LayerTiming(t_in, t_w, t_out, t_gen, t_eng, pipelined)
    if layer.m_valid and layer.valid_rows < M:
        ideal = layer_timing(
            dataclasses.replace(layer, M=layer.valid_rows, m_valid=0,
                                kv_bytes=layer.kv_bytes * layer.valid_rows
                                / M), hw)
        t.t_wasted = max(t.ii - ideal.ii, 0.0)
    return t


def model_layers(cfg, shape, *, n_devices: int = 256, tp: int = 16,
                 m_valid: int = 0, kv_len: int = 0) -> list[GemmLayer]:
    """Expand an LM-family (dense, MoE, SSM, hybrid, encoder-decoder, VLM)
    ModelConfig x ShapeConfig into per-device GEMM workloads. Decode: M = batch/dp
    tokens; train/prefill: M = batch*seq/dp. TP divides d_out
    (column-parallel) or d_in (row-parallel). ``m_valid`` marks the valid
    token rows (0 = all); ``kv_len`` attaches the per-step KV-read bytes to
    each attention block's output GEMM. A MoE block's routed experts are
    one workload per matrix at M = M * top_k / (E / tp) rows, the gate and
    up names carrying the per-device expert count as ``x{E}`` (the mapper
    strips it). A config with SSM state adds each layer's Mamba in/out
    projections (``ssm_in`` d -> 2 d_inner, ``ssm_out`` d_inner -> d, the
    reference's sizes for both Mamba versions); as in the reference, every
    layer also carries the attention and MLP workloads its ``n_heads`` and
    ``d_ff`` name (the hybrid's shared block counted at every layer). As in
the reference, an encoder-decoder's encoder layers and cross projections
and a VLM's image positions add no workload: the decoder stack alone is
expanded."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
        raise NotImplementedError(
            f"model_layers covers the LM families only, got {cfg.family!r}")
    dp = max(n_devices // tp, 1)
    if shape.kind == "decode":
        M = max(shape.global_batch // dp, 1)
    else:
        M = max(shape.global_batch * shape.seq_len // dp, 1)
    o = cfg.ovsf
    ex = o.exec_path if o.enable else "materialize"
    mv = min(max(m_valid // dp, 1), M) if m_valid else 0

    def mk(name, d_in, d_out, group):
        rho = o.rho_for(name) if (o.enable and group in o.targets
                                  and min(d_in, d_out) >= o.min_dim) else 1.0
        seg = o.seg_len if (o.seg_len and d_in % max(o.seg_len, 1) == 0) else 0
        is_ovsf = o.enable and rho < 1.0
        return GemmLayer(name, M, d_in, d_out, rho=rho,
                         ovsf=is_ovsf, exec_path=ex, seg=seg,
                         alpha_dtype=o.alpha_dtype if is_ovsf else "",
                         m_valid=mv)

    d, hd = cfg.d_model, cfg.hd
    kv_by = (2.0 * M * kv_len * max(cfg.n_kv_heads * hd // tp, hd) * 2
             if kv_len else 0.0)
    layers: list[GemmLayer] = []
    for i in range(cfg.n_layers):
        if cfg.n_heads:
            layers += [
                mk(f"L{i}/attn_q", d, cfg.n_heads * hd // tp, "attn"),
                mk(f"L{i}/attn_k", d, max(cfg.n_kv_heads * hd // tp, hd), "attn"),
                mk(f"L{i}/attn_v", d, max(cfg.n_kv_heads * hd // tp, hd), "attn"),
                dataclasses.replace(
                    mk(f"L{i}/attn_o", cfg.n_heads * hd // tp, d, "attn"),
                    kv_bytes=kv_by),
            ]
        if cfg.n_experts:
            e_dev = cfg.n_experts // tp
            m_e = M * cfg.top_k // max(e_dev, 1) or 1
            for nm in ("gate", "up"):
                l = mk(f"L{i}/expert_{nm}", d, cfg.d_ff, "expert")
                layers.append(dataclasses.replace(
                    l, M=m_e, name=l.name + f"x{e_dev}"))
            layers.append(dataclasses.replace(
                mk(f"L{i}/expert_down", cfg.d_ff, d, "expert"), M=m_e))
        elif cfg.d_ff:
            f = cfg.d_ff // tp
            if cfg.mlp_gated:
                layers.append(mk(f"L{i}/mlp_gate", d, f, "mlp"))
            layers += [mk(f"L{i}/mlp_up", d, f, "mlp"),
                       mk(f"L{i}/mlp_down", f, d, "mlp")]
        if cfg.ssm_state:
            di = cfg.d_inner // tp
            layers += [mk(f"L{i}/ssm_in", d, 2 * di, "mlp"),
                       mk(f"L{i}/ssm_out", di, d, "mlp")]
    return layers


@dataclasses.dataclass
class ModelTiming:
    layers: list
    timings: list
    total_s: float
    bounds: dict
    wasted_s: float = 0.0        # II seconds attributable to padding rows

    @property
    def step_efficiency(self) -> float:
        """1 - wasted/total in (0, 1]: how much of the modeled step was real
        work."""
        return 1.0 - (self.wasted_s / self.total_s if self.total_s else 0.0)

    def bound_of(self, name: str) -> BoundClass:
        for l, t in zip(self.layers, self.timings):
            if l.name == name:
                return t.bound
        raise KeyError(name)


def model_timing(layers: list[GemmLayer], hw: HW = V5E) -> ModelTiming:
    ts = [layer_timing(l, hw) for l in layers]
    bounds = {l.name: t.bound for l, t in zip(layers, ts)}
    return ModelTiming(layers, ts, sum(t.ii for t in ts), bounds,
                       wasted_s=sum(t.t_wasted for t in ts))


def serve_step_timing(cfg, *, valid_tokens: int, batch_tokens: int,
                      hw: HW = V5E, n_devices: int = 1, tp: int = 1,
                      kv_len: int = 0) -> ModelTiming:
    """Model one serving step of ``batch_tokens`` rows of which
    ``valid_tokens`` are real work (a decode-kind shape with the batch-token
    count as its rows); ``kv_len`` adds the KV-cache read bytes."""
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("serve_step", 1, batch_tokens, "decode")
    layers = model_layers(cfg, shape, n_devices=n_devices, tp=tp,
                          m_valid=valid_tokens, kv_len=kv_len)
    return model_timing(layers, hw)


def throughput(layers: list[GemmLayer], hw: HW = V5E,
               tokens_per_step: float = 1.0) -> float:
    """Steps (or inferences) per second under the II pipeline model."""
    mt = model_timing(layers, hw)
    return tokens_per_step / mt.total_s if mt.total_s > 0 else float("inf")
