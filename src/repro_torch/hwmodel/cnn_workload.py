"""CNN -> GEMM workload expansion (port of ``repro.hwmodel.cnn_workload``;
paper §4.1: R = H'W', P = Cin*K*K, C = Cout) for the analytical model,
tracking the spatial side through the net.

Used to reproduce the structure of the paper's Tables 1/4/5/6 with the
FPGA constants (ZC706/ZU7EV) and the registered targets. Unlike
``runtime.mapper._resnet_convs`` (ROADMAP C), the side here halves only at
the convs that stride, not at ``proj``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.hwmodel import perf_model as pm
from repro_torch.models.cnn import _FIRE, CNNConfig, _resnet_layers

# FPGA platforms from the paper (16-bit fixed; DSPs ~ 1 MAC each)
# ~10% of DSPs feed the CNN-WGen vector unit (paper Table 9: 7.5-11.3%)
ZC706 = pm.HW(peak_flops=2 * 810 * 150e6, hbm_bw=1.1e9, ici_bw=0,
              hbm_bytes=1e9, vmem_bytes=2_400_000,
              vpu_flops=2 * 810 * 150e6, wgen_flops=2 * 90 * 150e6)
ZU7EV = pm.HW(peak_flops=2 * 1555 * 200e6, hbm_bw=1.1e9, ici_bw=0,
              hbm_bytes=4e9, vmem_bytes=4_750_000,
              vpu_flops=2 * 1555 * 200e6, wgen_flops=2 * 173 * 200e6)


T_R = 256   # engine row-tile (paper DSE-typical); dense weight tiles are
            # re-read ceil(M/T_R) times per §4.1


def resnet_gemm_layers(cfg: CNNConfig, batch: int = 1) -> list[pm.GemmLayer]:
    """Per-layer GEMM workloads with the paper's im2col mapping."""
    plan = _resnet_layers(cfg)
    hw_size = cfg.in_hw
    layers = []
    cur = hw_size
    exec_path = "fused"   # TiWGen: tiles generated on-chip, consumed in place
    for d in plan:
        if d["name"] == "head":
            layers.append(pm.GemmLayer("head", batch, d["c_in"], d["c_out"]))
            continue
        if d["name"] == "stem":
            cur = math.ceil(hw_size / 2)
            out_hw = cur
            cur_after_pool = math.ceil(cur / 2)
        else:
            out_hw = math.ceil(cur / d["stride"])
        M = batch * out_hw * out_hw
        P = d["c_in"] * d["k"] * d["k"]
        rho = d["rho"]
        layers.append(pm.GemmLayer(
            d["name"], M, P, d["c_out"], rho=rho, seg=16,
            ovsf=cfg.ovsf_enable and rho < 1.0, exec_path=exec_path,
            alphas_resident=True, weight_reread=math.ceil(M / T_R)))
        if d["name"] == "stem":
            cur = cur_after_pool
        elif not d["name"].endswith("proj"):
            cur = out_hw
    return layers


def squeezenet_gemm_layers(cfg: CNNConfig, batch: int = 1
                           ) -> list[pm.GemmLayer]:
    layers = []
    hw_size = math.ceil(cfg.in_hw / 2)          # stem stride 2
    c_prev = 64
    layers.append(pm.GemmLayer("stem", batch * hw_size * hw_size, 27, 64))
    hw_size = math.ceil(hw_size / 2)            # pool
    for i, (sq, e1, e3, stage) in enumerate(_FIRE):
        M = batch * hw_size * hw_size
        rho = cfg.block_rhos[stage]
        rr = math.ceil(M / T_R)
        layers.append(pm.GemmLayer(f"f{i}s", M, c_prev, sq, weight_reread=rr))
        layers.append(pm.GemmLayer(f"f{i}e1", M, sq, e1, weight_reread=rr))
        layers.append(pm.GemmLayer(
            f"f{i}e3", M, sq * 9, e3, rho=rho, seg=16, exec_path="fused",
            ovsf=cfg.ovsf_enable and rho < 1.0, alphas_resident=True,
            weight_reread=rr))
        c_prev = e1 + e3
        if i in (1, 3):
            hw_size = math.ceil(hw_size / 2)
    layers.append(pm.GemmLayer("head", batch * hw_size * hw_size, c_prev,
                               cfg.num_classes))
    return layers


def cnn_gemm_layers(cfg: CNNConfig, batch: int = 1) -> list[pm.GemmLayer]:
    if cfg.depth == "squeezenet":
        return squeezenet_gemm_layers(cfg, batch)
    return resnet_gemm_layers(cfg, batch)


def pruned_variant(layers: list[pm.GemmLayer], keep: float
                   ) -> list[pm.GemmLayer]:
    """Taylor-style channel pruning baseline: keep a fraction of channels
    (both Cin and Cout shrink for chained CONVs -> FLOPs ~ keep^2). Channel
    counts round to multiples of 16 (hardware-friendly, OVSF-segment-exact)."""
    r16 = lambda n: max(16, int(round(n / 16)) * 16)
    out = []
    for i, l in enumerate(layers):
        d_in = r16(l.d_in * keep) if i > 0 else l.d_in
        d_out = r16(l.d_out * keep) if l.name != "head" else l.d_out
        out.append(dataclasses.replace(l, d_in=d_in, d_out=d_out, rho=1.0,
                                       ovsf=False))
    return out
