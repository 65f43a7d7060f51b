"""Packed-query attention over the paged KV cache (port of
``repro.models.attention.attn_apply_paged``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attn import paged_flash_decode
from repro_torch.models import layers as L


def attn_apply_paged(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     positions: torch.Tensor, slot_ids: torch.Tensor,
                     page_table: torch.Tensor, cache: dict
                     ) -> tuple[torch.Tensor, dict]:
    """``x`` is (1, T, d): T packed tokens of different slots; ``slot_ids`` /
    ``positions`` (T,) give each token's slot and cache position. The cache
    is this layer's ``{"k", "v"}`` (P, page_size, Hkv, hd) page pools,
    addressed through ``page_table`` (n_slots + 1, max_pages); position
    ``pos`` of a slot lives at ``(page_table[slot, pos // ps], pos % ps)``.

    New K/V are written into the pools IN PLACE (the reference returns new
    arrays; the returned dict holds the same, updated, tensors). Rows whose
    page is the sentinel P — ungranted pages and the padding row
    ``n_slots`` — are dropped, as the reference's ``mode="drop"`` scatter
    drops them. Then attention runs through ``paged_flash_decode``: the
    Hopper kernel on CUDA (the reference gathers the pages densely and never
    calls its Pallas kernel), the plain version on the CPU. Padding tokens
    read slot ``n_slots - 1``'s pages, as the reference's clipped gather
    does; their outputs are discarded by the caller.
    """
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    T = x.shape[1]
    k_pool, v_pool = cache["k"], cache["v"]
    P, ps = k_pool.shape[0], k_pool.shape[1]
    n_slots = page_table.shape[0] - 1
    npg = page_table.shape[1]
    q = L.linear_apply(p["q"], x, cfg, "attn_q").reshape(1, T, H, hd)
    k = L.linear_apply(p["k"], x, cfg, "attn_k").reshape(1, T, Hkv, hd)
    v = L.linear_apply(p["v"], x, cfg, "attn_v").reshape(1, T, Hkv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    slot_ids = slot_ids.long()
    positions = positions.long()
    page_of = page_table.long()[slot_ids.clamp(0, n_slots),
                                (positions // ps).clamp(0, npg - 1)]
    keep = (page_of >= 0) & (page_of < P)
    page_of, off = page_of[keep], (positions % ps)[keep]
    k_pool[page_of, off] = k[0][keep].to(k_pool.dtype)
    v_pool[page_of, off] = v[0][keep].to(v_pool.dtype)

    sid = slot_ids.clamp(0, n_slots - 1)
    out = paged_flash_decode(q[0], k_pool, v_pool, page_table, sid,
                             positions)                      # (T, H, hd)
    y = L.linear_apply(p["o"], out.reshape(1, T, H * hd), cfg,
                       "attn_o")
    return y, {"k": k_pool, "v": v_pool}
