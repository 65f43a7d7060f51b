"""Entry points over the model stack (port of ``repro.models.registry``)."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T


def _norm(cfg: ModelConfig, device) -> dict:
    return {"scale": torch.ones((cfg.d_model,), dtype=cfg.act_dtype,
                                device=device)}


def _block_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """One layer of the family's stack: attention + MLP (dense, VLM; the
    hybrid's shared block), attention + cross attention + MLP (the
    encoder-decoder's decoder), attention + MoE, or a Mamba-1 (SSM) /
    Mamba-2 (hybrid) block."""
    if cfg.family in ("ssm", "hybrid"):
        init = SSM.mamba1_init if cfg.family == "ssm" else SSM.mamba2_init
        return {"norm1": _norm(cfg, device),
                "mamba": init(gen, cfg, device)}
    return _attn_block_init(gen, cfg, device, cross=cfg.family == "encdec")


def _attn_block_init(gen: torch.Generator, cfg: ModelConfig, device,
                     cross: bool = False) -> dict:
    """Attention + MLP (or MoE); with ``cross``, a cross-attention
    sub-block (``norm_x``, ``cross``) whose linears are named ``cross_*``,
    so never OVSF (``"cross"`` is no OVSF target), as the reference's."""
    d, H, Hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)

    def lin(name, d_in, d_out, bias=False):
        return L.linear_init(gen, cfg, name, d_in, d_out, device, bias=bias)

    def attn(pre):
        return {"q": lin(f"{pre}_q", d, H * hd, cfg.qkv_bias),
                "k": lin(f"{pre}_k", d, Hkv * hd, cfg.qkv_bias),
                "v": lin(f"{pre}_v", d, Hkv * hd, cfg.qkv_bias),
                "o": lin(f"{pre}_o", H * hd, d)}

    if cfg.family == "moe":
        ffn = {"moe": M.moe_init(gen, cfg, device)}
    else:
        mlp = {"up": lin("mlp_up", d, f), "down": lin("mlp_down", f, d)}
        if cfg.mlp_gated:
            mlp["gate"] = lin("mlp_gate", d, f)
        ffn = {"mlp": mlp}
    p = {"norm1": _norm(cfg, device), "attn": attn("attn"),
         "norm2": _norm(cfg, device), **ffn}
    if cross:
        p["norm_x"] = _norm(cfg, device)
        p["cross"] = attn("cross")
    return p


def _model_init(cfg: ModelConfig, gen, dev) -> dict:
    dtype = cfg.act_dtype
    p: dict = {
        "embed": {"table": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                       dtype=dtype, device=dev) * 0.02},
        "blocks": [_block_init(gen, cfg, dev) for _ in range(cfg.n_layers)],
        "final_norm": _norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": torch.randn((cfg.d_model, cfg.vocab),
                                         generator=gen, dtype=dtype,
                                         device=dev) * 0.02}
    if cfg.family == "hybrid":
        p["shared_attn"] = _attn_block_init(gen, cfg, dev)
    if cfg.family == "encdec":
        p["encoder"] = {"blocks": [_attn_block_init(gen, cfg, dev)
                                   for _ in range(cfg.encoder_layers)],
                        "norm": _norm(cfg, dev)}
    return p


def model_init(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the same shapes, key names and init statistics
    as ``repro.models.registry.model_init``, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the numbers differ from the
    reference's ``jax.random`` ones; ``models.bridge`` carries those over).
    ``blocks`` is a list of per-layer dicts; the hybrid's weight-shared
    attention block is ``shared_attn``; the encoder-decoder's encoder is
    ``encoder`` = ``{"blocks": [...], "norm"}``."""
    T._check_family(cfg)
    dev = resolve_device(device)
    return _model_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                       dev)


def model_init_specs(cfg: ModelConfig) -> dict:
    """The parameter tree of ``model_init`` as ``meta`` tensors: shapes and
    dtypes, nothing allocated (the reference's ``jax.eval_shape``)."""
    T._check_family(cfg)
    return _model_init(cfg, None, torch.device("meta"))


def leaves(params) -> list:
    """The tensors of a parameter tree, in order."""
    if isinstance(params, torch.Tensor):
        return [params]
    items = params.values() if isinstance(params, dict) else params
    return [t for v in items for t in leaves(v)]


def param_count(params) -> int:
    return sum(t.numel() for t in leaves(params))


def params_to(params, device):
    """A copy of the param tree on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return [params_to(v, device) for v in params]


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """The training loss: ``(total, {"loss", "aux"})``."""
    return T.lm_loss(params, cfg, batch)


def forward(params, cfg: ModelConfig, batch: dict):
    """The cache-free forward: ``(logits, None, aux)``."""
    return T.model_apply(params, cfg, batch)


serve_prefill = T.serve_prefill
serve_prefill_ragged = T.serve_prefill_ragged
serve_step = T.serve_step
serve_step_window = T.serve_step_window
serve_step_packed = T.serve_step_packed
init_cache = T.init_cache
cache_shapes = T.cache_shapes
serve_step_paged = T.serve_step_paged
serve_step_window_paged = T.serve_step_window_paged
init_paged_cache = T.init_paged_cache
serve_step_packed_multi = T.serve_step_packed_multi
serve_step_window_multi = T.serve_step_window_multi
