"""Base layers: linear (dense or OVSF), RMSNorm, embedding, RoPE (port of
``repro.models.layers``).

Params are plain nested dicts of tensors with the reference's key names, so
the bridge from the JAX pytree is a one-to-one copy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ovsf
from repro_torch.kernels import ops as kops


def ovsf_eligible(cfg: ModelConfig, name: str, d_in: int, d_out: int) -> bool:
    oc = cfg.ovsf
    if not oc.enable or min(d_in, d_out) < oc.min_dim:
        return False
    group = name.split("_")[0]          # attn_q -> attn, mlp_up -> mlp
    return group in oc.targets and oc.rho_for(name) < 1.0 + 1e-9


def linear_init(gen: torch.Generator, cfg: ModelConfig, name: str, d_in: int,
                d_out: int, device, bias: bool = False,
                scale: float = 1.0) -> dict:
    """Same shapes, key names and init statistics as the reference."""
    dtype = cfg.act_dtype
    p: dict = {}
    if ovsf_eligible(cfg, name, d_in, d_out):
        seg = cfg.ovsf.seg_len if (cfg.ovsf.seg_len
                                   and d_in % cfg.ovsf.seg_len == 0) else 0
        spec = ovsf.OVSFSpec(d_in, d_out, rho=cfg.ovsf.rho_for(name),
                             strategy=cfg.ovsf.strategy, seg=seg)
        p.update(ovsf.init_ovsf(gen, spec, scale=scale, dtype=dtype,
                                device=device))
        if cfg.ovsf.alpha_dtype:
            p = ovsf.quantize_params(p, cfg.ovsf.alpha_dtype)
    else:
        std = float(np.sqrt(scale / d_in))
        p["w"] = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                             device=device) * std
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def layer_plan(cfg: ModelConfig, name: str):
    """The mapper's LayerPlan for a weight-type name, or None."""
    if cfg.exec_plan is None or not name:
        return None
    return cfg.exec_plan.plan_for(name)


def linear_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 name: str = "", mids: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Dense layers are one ``torch.matmul``. OVSF layers dispatch by the
    mapper's plan for weight type ``name`` (e.g. "mlp_up") when
    ``cfg.exec_plan`` holds one, else by ``cfg.ovsf.exec_path``. ``mids``
    (x.shape[:-1] integer ids) picks each token's variant when the alpha
    bank is stacked (M, J, d_out): ``ovsf_matmul_multi``, the multi-model
    gateway's same-architecture batching. Dense and unstacked OVSF leaves
    are shared by the variants and ignore ``mids``."""
    if "alphas" in p or "alphas_q8" in p or "alphas_q4" in p:
        al, scale, adt = ovsf.alpha_params(p)
        if mids is not None and al.dim() == 3:
            y = kops.ovsf_matmul_multi(x, al, p["idx"], mids,
                                       alpha_scale=scale, alpha_dtype=adt)
        else:
            y = kops.ovsf_matmul(x, al, p["idx"], path=cfg.ovsf.exec_path,
                                 plan=layer_plan(cfg, name),
                                 alpha_scale=scale, alpha_dtype=adt)
    else:
        y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def linear_convert_to_ovsf(p: dict, rho: float, strategy: str = "iterative",
                           seg: int = 16, alpha_dtype: str = "") -> dict:
    """A dense linear's params {"w", "b"?} -> OVSF params (the paper's
    Converter): ``core.ovsf.compress_matrix`` of w in fp32 over codes of
    length ``seg``, or monolithic codes (seg 0) where ``seg`` is 0 or does
    not divide d_in; fp32/bf16 alphas in w's type, or with ``alpha_dtype``
    "int8"/"int4" the quantised storage form (alphas_q8/alphas_q4 and the
    fp32 per-segment alpha_scale); the bias passes through."""
    w = p["w"]
    if seg and w.shape[0] % seg:
        seg = 0
    spec = ovsf.OVSFSpec(w.shape[0], w.shape[1], rho=rho, strategy=strategy,
                         seg=seg, alpha_dtype=alpha_dtype)
    out = ovsf.compress_matrix(w.to(torch.float32), spec)
    if "alphas" in out:
        out = {"alphas": out["alphas"].to(w.dtype), "idx": out["idx"]}
    if "b" in p:
        out["b"] = p["b"]
    return out


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,). Split-half convention:
    the first and second halves of each head are the rotated pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs    # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)
