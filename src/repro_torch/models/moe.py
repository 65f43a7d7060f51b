"""Mixture-of-Experts block: grouped top-k routing with capacity and
GShard-style one-hot dispatch (port of ``repro.models.moe``).

Each routing group of ``g = min(MOE_GROUP, T)`` tokens (the last one padded
with zero rows) computes fp32 router probabilities, keeps each token's
``top_k`` experts (renormalised), and queues every (token, choice) pair at
its expert in row-major (token, choice) order; a pair whose queue position
reaches the capacity ``ceil(capacity_factor * top_k * g / E)`` is dropped
(its gate zeroed). Dispatch and combine are one-hot einsums of fixed
shapes: no host read, no data-dependent shape, so a step holding them is
captured as a CUDA graph, and no gather or scatter can fall out of bounds
(the reference's are the same einsums). Ties in the router's top-k keep
the lower expert first, as ``lax.top_k`` does: a stable descending sort.

Expert weights are banks stacked over the experts: dense ``w`` (E, d_in,
d_out), or OVSF ``alphas`` (E, J, d_out) sharing one ``idx`` (float alphas
whatever ``alpha_dtype`` says, as the reference builds them). A bank runs
the reference's dataflow: ``spectral`` transforms the dispatched
activations once and contracts each expert's alphas; every other plan
(``fused`` included: the reference has no per-expert generate-and-multiply
kernel) regenerates the bank's dense W (``kernels.ops.decompress_bank``:
segmented codes in one launch of the segmented ``ovsf_decompress`` kernel
over the E experts on the card, the reference's vmap of ``decompress``;
through the decompress cache when the plan caches and autograd records
no alphas), then one batched product.

Under autograd (the train step) the gradients reach the router through
the renormalised top-k gates (the sorted probabilities, as ``lax.top_k``'s
values carry them) and the aux loss's mean probabilities; the one-hot
dispatch, the queue positions and the aux's choice counts carry none, as
in the reference.

``per_row=True`` routes each batch row as its own set of groups: the
reference's contiguous decode and window steps vmap ``moe_apply`` over the
slots, so each slot routes (and fills capacity) alone there, while its
packed, paged and prefill steps route the whole batch together.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ovsf
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

MOE_GROUP = 1024   # tokens per routing group, as the reference's


def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Same shapes, key names and init statistics as the reference."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p: dict = {"router": {"w": torch.randn((d, E), generator=gen,
                                           dtype=cfg.act_dtype,
                                           device=device) * 0.02}}
    p.update(_expert_bank_init(gen, cfg, E, d, f, "expert", device))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "gate": L.linear_init(gen, cfg, "mlp_gate", d, fs, device),
            "up": L.linear_init(gen, cfg, "mlp_up", d, fs, device),
            "down": L.linear_init(gen, cfg, "mlp_down", fs, d, device),
        }
    return p


def _expert_bank_init(gen: torch.Generator, cfg: ModelConfig, E: int, d: int,
                      f: int, name: str, device) -> dict:
    """Stacked (E, ...) expert weights, OVSF-compressed when eligible: float
    (E, J, d_out) alphas and one (n_seg, n_keep) or (J,) ``idx``."""
    dtype = cfg.act_dtype
    out: dict = {}
    for nm, d_in, d_out in (("gate", d, f), ("up", d, f), ("down", f, d)):
        full = f"{name}_{nm}"
        if L.ovsf_eligible(cfg, full, d_in, d_out):
            seg = cfg.ovsf.seg_len if (cfg.ovsf.seg_len
                                       and d_in % cfg.ovsf.seg_len == 0) else 0
            spec = ovsf.OVSFSpec(d_in, d_out, rho=cfg.ovsf.rho_for(full),
                                 strategy=cfg.ovsf.strategy, seg=seg)
            subs = [ovsf.init_ovsf(gen, spec, dtype=dtype, device=device)
                    for _ in range(E)]
            out[nm] = {"alphas": torch.stack([s["alphas"] for s in subs]),
                       "idx": subs[0]["idx"]}
        else:
            std = float(np.sqrt(1.0 / d_in))
            out[nm] = {"w": torch.randn((E, d_in, d_out), generator=gen,
                                        dtype=dtype, device=device) * std}
    return out


def _expert_matmul(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   name: str = "") -> torch.Tensor:
    """x: (G, E, C, d_in) batched per-expert GEMM -> (G, E, C, d_out)."""
    if "alphas" not in p:
        return torch.einsum("gecd,edn->gecn", x, p["w"].to(x.dtype))
    al, idx = p["alphas"], p["idx"]
    plan = L.layer_plan(cfg, name)
    path = plan.path if plan is not None else cfg.ovsf.exec_path
    if path == "spectral":
        xk = kops.spectral_transform(x, idx)                 # (G, E, C, J)
        return torch.einsum("gecj,ejn->gecn", xk, al.to(xk.dtype))
    d_in = x.shape[-1]
    # a cached W would carry a finished step's graph
    records = torch.is_grad_enabled() and al.requires_grad
    if plan is not None and plan.cache_weights and not records:
        W = kops.cached_decompress(al, idx, d_in,
                                   cache_key=plan.cache_key or name)
    else:
        W = kops.decompress_bank(al, idx, d_in)              # (E, d_in, d_out)
    return torch.einsum("gecd,edn->gecn", x, W.to(x.dtype))


def _one_hot(i: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot rows of integer ``i``, by comparison: no host read
    of the ids (``F.one_hot`` checks their range on the host off CUDA)."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


def _groups(x: torch.Tensor, per_row: bool) -> tuple[torch.Tensor, int]:
    """(B, S, d) -> ((G, g, d) routing groups, g): the B*S tokens in
    row-major order (or each row's S tokens alone), zero-padded to a
    multiple of g = min(MOE_GROUP, tokens)."""
    B, S, d = x.shape
    rows = x if per_row else x.reshape(1, B * S, d)
    n = rows.shape[1]
    g = min(MOE_GROUP, n)
    pad = (-n) % g
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    return rows.reshape(-1, g, d), g


def route(p: dict, cfg: ModelConfig, xg: torch.Tensor) -> dict:
    """The router over (G, g, d) groups: fp32 ``probs`` (G, g, E), the
    chosen experts ``gate_idx`` (G, g, k), their renormalised gates with
    the dropped pairs zeroed ``gate_vals``, the ``keep`` mask, each pair's
    queue ``pos`` at its expert and the capacity ``cap``."""
    E, k = cfg.n_experts, cfg.top_k
    g = xg.shape[1]
    logits = (xg @ p["router"]["w"].to(xg.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # (G, g, E)
    # lax.top_k's order: descending, the lower index first among ties
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], order[..., :k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    cap = max(int(np.ceil(cfg.capacity_factor * k * g / E)), 1)
    onehot = _one_hot(gate_idx, E, torch.int32)              # (G, g, k, E)
    flat = onehot.reshape(-1, g * k, E)
    pos_all = torch.cumsum(flat, dim=1) - flat               # (G, g*k, E)
    pos = (pos_all * flat).sum(-1).reshape(gate_idx.shape)
    keep = pos < cap
    return dict(probs=probs, gate_idx=gate_idx, gate_vals=gate_vals * keep,
                keep=keep, pos=pos, cap=cap, onehot=onehot)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              per_row: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Grouped top-k dispatch with capacity;
    ``per_row`` routes each row alone (module docstring). The aux loss is
    the Switch load-balance term over every group."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xg, g = _groups(x, per_row)
    r = route(p, cfg, xg)
    cap = r["cap"]
    dt = xg.dtype
    pos_oh = _one_hot(torch.where(r["keep"], r["pos"], cap), cap + 1,
                      dt)[..., :cap]                         # (G, g, k, cap)
    oh = r["onehot"].to(dt)
    disp = torch.einsum("gtke,gtkc->gtec", oh, pos_oh)       # (G, g, E, cap)
    comb = torch.einsum("gtk,gtke,gtkc->gtec", r["gate_vals"].to(dt), oh,
                        pos_oh)
    ex_in = torch.einsum("gtec,gtd->gecd", disp, xg)         # (G, E, cap, d)
    gg = _expert_matmul(p["gate"], ex_in, cfg, "expert_gate")
    uu = _expert_matmul(p["up"], ex_in, cfg, "expert_up")
    h = torch.nn.functional.silu(gg.to(torch.float32)).to(uu.dtype) * uu
    ex_out = _expert_matmul(p["down"], h, cfg, "expert_down")
    y = torch.einsum("gtec,gecd->gtd", comb, ex_out)        # (G, g, d)
    if per_row:
        y = y.reshape(B, -1, d)[:, :S]
    else:
        y = y.reshape(-1, d)[:B * S].reshape(B, S, d)

    if "shared" in p:
        sp = p["shared"]
        g2 = L.linear_apply(sp["gate"], x, cfg, "mlp_gate")
        u2 = L.linear_apply(sp["up"], x, cfg, "mlp_up")
        y = y + L.linear_apply(
            sp["down"],
            torch.nn.functional.silu(g2.to(torch.float32)).to(u2.dtype) * u2,
            cfg, "mlp_down")

    # load-balance auxiliary loss (Switch): E * sum_e f_e * P_e
    me = r["onehot"].sum(2).to(torch.float32).mean(dim=(0, 1))
    pe = r["probs"].mean(dim=(0, 1))
    aux = E * torch.sum(me * pe) / k
    return y.to(x.dtype), aux
