"""Dense decoder trunk over the paged KV cache (port of the dense family of
``repro.models.transformer``).

The reference's ``lax.scan`` over stacked ``blocks`` becomes a Python loop
over a list of per-layer param dicts; the paged K/V pools stay stacked
``(n_layers, P, page_size, Hkv, hd)`` tensors, written in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

_FAMILIES = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the port serves the dense family only so far, got "
            f"{cfg.family!r}")


def _mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    u = L.linear_apply(p["up"], x, cfg, "mlp_up")
    if cfg.mlp_gated:
        g = L.linear_apply(p["gate"], x, cfg, "mlp_gate")
        h = (torch.nn.functional.silu(g.to(torch.float32))
             * u.to(torch.float32)).to(x.dtype)
    else:
        h = torch.nn.functional.gelu(u.to(torch.float32)).to(x.dtype)
    return L.linear_apply(p["down"], h, cfg, "mlp_down")


def _paged_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                 slot_ids: torch.Tensor, positions: torch.Tensor,
                 page_table: torch.Tensor, cache: dict) -> torch.Tensor:
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    y, _ = A.attn_apply_paged(p["attn"], cfg, h, positions=positions,
                              slot_ids=slot_ids, page_table=page_table,
                              cache=cache)
    x = x + y
    h = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    return x + _mlp_apply(p["mlp"], cfg, h)


def _unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T.to(x.dtype)
    return x @ params["lm_head"]["w"].to(x.dtype)


def paged_cache_shapes(cfg: ModelConfig, page_size: int, n_pages: int
                       ) -> dict[str, tuple]:
    """Shapes of the paged serving cache: per-layer K/V page pools shared by
    every slot, stacked over layers."""
    _check_family(cfg)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k": shape, "v": shape}


def init_paged_cache(cfg: ModelConfig, page_size: int, n_pages: int,
                     device) -> dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=cfg.act_dtype, device=device)
            for name, shape in paged_cache_shapes(cfg, page_size,
                                                  n_pages).items()}


def serve_step_paged(params: dict, cfg: ModelConfig, cache: dict,
                     page_table: torch.Tensor, tokens: torch.Tensor,
                     slot_ids: torch.Tensor, positions: torch.Tensor,
                     new_pos: torch.Tensor, emit_idx: torch.Tensor
                     ) -> tuple[torch.Tensor, dict]:
    """Token-packed step against the paged KV cache.

    tokens / slot_ids / positions: (T,) — every token of the step, the pow-2
    tail padding carrying ``slot_id == n_slots``. new_pos / emit_idx: (B,)
    post-step fill levels and the packed index of each slot's last token.
    page_table: (n_slots + 1, max_pages) int32, shared by every layer.
    Returns ((B, vocab) logits at ``emit_idx``, the cache with its K/V pools
    updated in place and ``pos`` set to ``new_pos``).
    """
    _check_family(cfg)
    x = L.embed_apply(params["embed"], tokens[None])           # (1, T, d)
    for li, p in enumerate(params["blocks"]):
        x = _paged_block(p, cfg, x, slot_ids=slot_ids, positions=positions,
                         page_table=page_table,
                         cache={"k": cache["k"][li], "v": cache["v"][li]})
    feats = x[0][emit_idx.long()]                               # (B, d)
    logits = _unembed(params, cfg, feats[None])[0]              # (B, vocab)
    new_cache = dict(cache)
    new_cache["pos"] = new_pos
    return logits, new_cache


def serve_step_window_paged(params: dict, cfg: ModelConfig, cache: dict,
                            page_table: torch.Tensor, tokens: torch.Tensor,
                            n_valid: torch.Tensor
                            ) -> tuple[torch.Tensor, dict]:
    """Advance slot b by ``n_valid[b]`` of its W supplied tokens ((B, W)
    window), returning each slot's logits at column ``n_valid[b] - 1``: the
    window is flattened onto ``serve_step_paged``; padding columns become
    sentinel-slot tokens at position 0. ``cache["pos"]`` is (B,)."""
    B, W = tokens.shape
    dev = tokens.device
    pos0 = cache["pos"].long()
    col = torch.arange(W, device=dev)
    valid = col[None, :] < n_valid[:, None]
    slot_ids = torch.where(valid, torch.arange(B, device=dev)[:, None],
                           B).reshape(-1)
    positions = torch.where(valid, pos0[:, None] + col[None, :],
                            0).reshape(-1)
    new_pos = pos0 + n_valid
    emit_idx = torch.arange(B, device=dev) * W + (n_valid - 1).clamp(0, W - 1)
    return serve_step_paged(params, cfg, cache, page_table, tokens.reshape(-1),
                            slot_ids, positions, new_pos, emit_idx)
