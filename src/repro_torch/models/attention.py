"""GQA attention over the serving KV caches (port of the cache paths of
``repro.models.attention``): ``attn_apply`` over the contiguous per-slot
cache (and, cache-free, the encoder's ``bidir`` mode),
``attn_apply_packed`` over the same cache with a packed token stream,
``attn_apply_paged`` over the paged pools; for the encoder-decoder family,
``make_cross_cache`` (encoder K/V), ``cross_attend`` over it (the
reference's ``attn_apply`` in ``cross`` mode) and ``cross_attn_packed``
over per-slot cross caches with a packed token stream.

The caches are written IN PLACE (the reference returns new arrays; the
returned dicts hold the same, updated, tensors), and with no host sync, so
that a step can be captured as a CUDA graph: the packed and paged writes
send a dropped row to the layer's scratch row (``drop_write``) instead of
compacting the kept rows with a boolean mask. Single-token attention runs
through the Hopper kernels on CUDA (``flash_decode_attn``,
``paged_flash_decode``) and their plain versions on the CPU; the reference
leaves it to an XLA einsum. Cross attention at S == 1 is
``flash_decode_attn`` with every row's ``pos`` at the cross cache's
length, no column masked: the reference's unmasked ``sdpa``. The cross
caches (encoder K/V) are in the model dtype whatever ``kv_cache_dtype``
says, as the reference's: a cross read never sees int8.

An int8 cache (``ModelConfig.kv_cache_dtype="int8"``) stores each written
K/V as ``quant_like`` does (the reference's static-scale ``_quant_like``).
The kernels take the int8 K/V as they are and dequantise as they load
(never a dequantised copy of the cache); the S > 1 path reads the cache
through ``dequant`` into the plain ``sdpa``, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attn import (flash_decode_attn,
                                             paged_flash_decode)
from repro_torch.kernels.ref import dequant, quant_like
from repro_torch.models import layers as L


# query rows of one plain ``sdpa`` call in ``attn_apply``: its fp32 scores
# are (B, H, rows, T), so a prefill's attention temporaries grow with the
# bucket Lb, not Lb^2 (a captured bucket keeps them in its graph's pool);
# each query's softmax is its own, so the rows split freely
SDPA_ROWS = 64


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped scaled-dot-product attention, plain torch ops. q: (B, S, H,
    hd), k/v: (B, T, Hkv, hd), mask (B, S, T) or (S, T), True = attend.
    As the reference: q * scale rounded to q's type, fp32 scores and
    softmax, probabilities in v's type, fp32 sums, output in q's type."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / float(hd) ** 0.5
    qs = (q.to(torch.float32) * scale).to(q.dtype)
    logits = torch.einsum("bsngd,btnd->bnsgt",
                          qs.reshape(B, S, Hkv, G, hd).to(torch.float32),
                          k.to(torch.float32))
    if mask is not None:
        m = (mask[:, None, :, None, :] if mask.dim() == 3
             else mask[None, None, :, None, :])
        # in place (one copy) unless autograd records the scores
        logits = (logits.masked_fill(~m, -1e30) if logits.requires_grad
                  else logits.masked_fill_(~m, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnsgt,btnd->bsngd", probs.to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def drop_write(cache: dict, rows: torch.Tensor, keep: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor) -> None:
    """K/V row t into flat row ``rows[t]`` of this layer's cache where
    ``keep[t]``, indices computed on the device and never compacted. A
    dropped row (the reference's ``mode="drop"``) goes to the scratch row
    after the layer's R rows (``cache["k_rows"]`` / ``"v_rows"``, (R + 1,
    Hkv, hd), allocated with the cache by ``init_cache`` /
    ``init_paged_cache``; no read addresses it), so it never races a kept
    row for a real cell. A cache allocated without that row (a caller's
    own tensors) is written through a padded copy of itself, copied back.
    Kept rows with one target leave one of their values, as the
    reference's scatter does. K/V are stored as ``quant_like`` gives them
    in the cache's type."""
    for name, src in (("k", k), ("v", v)):
        dst = cache[name]
        flat = cache.get(name + "_rows")
        pad = flat is None
        if pad:
            flat = torch.cat([dst.reshape((-1,) + dst.shape[-2:]),
                              dst.new_zeros((1,) + dst.shape[-2:])])
        idx = torch.where(keep, rows, flat.shape[0] - 1)
        flat.index_copy_(0, idx, quant_like(src, flat.dtype))
        if pad:
            dst.copy_(flat[:-1].view(dst.shape))


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
         mids: Optional[torch.Tensor] = None):
    """q, k, v of (B, S, d) x, RoPE on q and k at ``positions`` ((B, S) or
    (S,)); ``mids`` (B, S) picks each token's stacked-alpha variant."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = L.linear_apply(p["q"], x, cfg, "attn_q", mids).reshape(B, S, H, hd)
    k = L.linear_apply(p["k"], x, cfg, "attn_k", mids).reshape(B, S, Hkv, hd)
    v = L.linear_apply(p["v"], x, cfg, "attn_v", mids).reshape(B, S, Hkv, hd)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _sdpa_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``sdpa`` ``SDPA_ROWS`` queries at a time (``mask`` (B, S, T) or
    None)."""
    return torch.cat([sdpa(q[:, i:i + SDPA_ROWS], k, v,
                           None if mask is None else mask[:, i:i + SDPA_ROWS])
                      for i in range(0, q.shape[1], SDPA_ROWS)], dim=1)


def attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Optional[dict] = None,
               cache_pos: Optional[torch.Tensor] = None,
               mode: str = "causal") -> tuple[torch.Tensor, Optional[dict]]:
    """Self-attention of S new tokens per row, causal or bidirectional.

    ``causal``: over the contiguous cache. ``x`` is (B, S, d);
    ``positions`` (B, S) their RoPE positions; ``cache`` this layer's
    ``{"k", "v"}`` (B, T, Hkv, hd) buffers; ``cache_pos`` (B,) each row's
    fill level (the reference vmaps one slot at a time with a scalar). The
    S new K/V rows land at ``cache_pos[b]``, the start clamped to ``[0, T -
    S]`` as ``dynamic_update_slice`` clamps it; query s of row b then
    attends columns ``<= cache_pos[b] + s``. S == 1 runs
    ``flash_decode_attn`` with pos ``cache_pos + 1``; S > 1 the plain
    ``sdpa``, as the reference leaves it to XLA, ``SDPA_ROWS`` queries at a
    time.

    ``bidir`` (the encoder's): RoPE at ``positions``, no mask, no cache;
    returns (y, None). ``causal`` without a cache is the training forward
    (the reference's ``cache=None`` branch): the (S,) ``positions`` of the
    whole sequence, query s attending keys ``<= s``, one plain ``sdpa``,
    nothing written in place; returns (y, None). The reference's third
    mode, ``cross``, is ``cross_attend`` over ``make_cross_cache``'s K/V
    here.
    """
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = _qkv(p, cfg, x, positions)
    if cache is None and mode in ("bidir", "causal"):
        if mode == "bidir":
            out = _sdpa_rows(q, k, v, None)
        else:
            t = torch.arange(S, device=x.device)
            out = sdpa(q, k, v, t[None, :] <= t[:, None])
        y = L.linear_apply(p["o"], out.reshape(B, S, H * hd), cfg, "attn_o")
        return y, None
    if mode != "causal":
        raise ValueError(f"attn_apply: mode {mode!r} with a cache: bidir "
                         "attention runs without one")
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[1]
    cache_pos = cache_pos.long()
    start = cache_pos.clamp(0, max(T - S, 0))
    rows = torch.arange(B, device=x.device)[:, None]
    cols = start[:, None] + torch.arange(S, device=x.device)[None, :]
    ck[rows, cols] = quant_like(k, ck.dtype)
    cv[rows, cols] = quant_like(v, cv.dtype)
    if S == 1:
        out = flash_decode_attn(q[:, 0], ck, cv, cache_pos + 1)[:, None]
    else:
        idx = cache_pos[:, None] + torch.arange(S, device=x.device)[None, :]
        mask = (torch.arange(T, device=x.device)[None, None, :]
                <= idx[:, :, None])                         # (B, S, T)
        out = _sdpa_rows(q, dequant(ck, q.dtype), dequant(cv, q.dtype), mask)
    y = L.linear_apply(p["o"], out.reshape(B, S, H * hd), cfg, "attn_o")
    return y, {"k": ck, "v": cv}


def cross_attend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Cross attention of (B, S, d) ``x`` over (B, Te, Hkv, hd) ``xk`` /
    ``xv``, no RoPE and no mask: S == 1 through ``flash_decode_attn`` with
    pos Te on every row, S > 1 through the plain ``sdpa``, ``SDPA_ROWS``
    queries at a time (the reference's ``sdpa`` with ``mask=None``)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = L.linear_apply(p["q"], x, cfg, "attn_q").reshape(B, S, H, hd)
    if S == 1:
        out = flash_decode_attn(q[:, 0], xk, xv, xk.shape[1])[:, None]
    else:
        out = _sdpa_rows(q, dequant(xk, q.dtype), dequant(xv, q.dtype), None)
    return L.linear_apply(p["o"], out.reshape(B, S, H * hd), cfg, "attn_o")


def make_cross_cache(p: dict, cfg: ModelConfig, src: torch.Tensor) -> dict:
    """Encoder K/V for cross attention: ``{"k", "v"}`` (B, Tf, Hkv, hd)
    projected from the (B, Tf, d) encoder output ``src``, in its type."""
    B, Tf, _ = src.shape
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    k = L.linear_apply(p["k"], src, cfg, "attn_k").reshape(B, Tf, Hkv, hd)
    v = L.linear_apply(p["v"], src, cfg, "attn_v").reshape(B, Tf, Hkv, hd)
    return {"k": k, "v": v}


def cross_attn_packed(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      slot_ids: torch.Tensor, cache: dict,
                      mids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed-query cross attention: each of the (1, T, d) ``x``'s tokens
    attends its slot's precomputed encoder K/V (``cache["k"]`` / ``"v"``,
    (B, Te, Hkv, hd)), no mask, through ``flash_decode_attn`` with pos Te
    over the gathered rows ``k[sid]`` / ``v[sid]`` ((T, Te, Hkv, hd) per
    layer, as ``attn_apply_packed`` gathers and the reference's
    ``jnp.take`` copies). Slot ids are clipped into ``[0, B - 1]`` as the
    reference clips them: a padding token (slot id B) reads slot B - 1,
    its output discarded by the caller. ``mids`` (T,) picks each token's
    stacked-alpha variant."""
    H, hd = cfg.n_heads, cfg.hd
    T = x.shape[1]
    xk, xv = cache["k"], cache["v"]
    m2 = None if mids is None else mids[None, :]
    q = L.linear_apply(p["q"], x, cfg, "attn_q", m2).reshape(T, H, hd)
    sid = slot_ids.long().clamp(0, xk.shape[0] - 1)
    out = flash_decode_attn(q, xk[sid], xv[sid], xk.shape[1])   # (T, H, hd)
    return L.linear_apply(p["o"], out.reshape(1, T, H * hd), cfg, "attn_o",
                          m2)


def attn_apply_packed(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, slot_ids: torch.Tensor,
                      cache: dict, mids: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, dict]:
    """Packed-query attention over the contiguous per-slot cache.

    ``x`` is (1, T, d): T tokens of different slots; ``slot_ids`` /
    ``positions`` (T,) give each token's cache row and position in it;
    ``cache`` is this layer's ``{"k", "v"}`` (B, Tbuf, Hkv, hd). Padding
    tokens carry ``slot_id == B``: their writes are dropped, as are writes
    past Tbuf (the reference's ``mode="drop"``; ``drop_write``), and their
    gather is clipped to slot B - 1 (outputs discarded by the caller). Each
    token then attends its slot's gathered row under ``col <= positions[t]``
    through ``flash_decode_attn`` with pos ``positions + 1``; the gather
    copies (T, Tbuf, Hkv, hd) per layer, as the reference's ``jnp.take``
    does, in the cache's type (an int8 row cast to q's type without the
    scale would be silently wrong; the kernel dequantises it). ``mids``
    (T,) picks each token's stacked-alpha variant (multi-model steps).
    """
    H, hd = cfg.n_heads, cfg.hd
    T = x.shape[1]
    ck, cv = cache["k"], cache["v"]
    B, Tbuf = ck.shape[0], ck.shape[1]
    m2 = None if mids is None else mids[None, :]            # (1, T)
    q, k, v = _qkv(p, cfg, x, positions, m2)
    slot_ids = slot_ids.long()
    positions = positions.long()
    keep = (slot_ids >= 0) & (slot_ids < B) & (positions >= 0) & \
        (positions < Tbuf)
    drop_write(cache, slot_ids * Tbuf + positions, keep, k[0], v[0])
    sid = slot_ids.clamp(0, B - 1)
    out = flash_decode_attn(q[0], ck[sid], cv[sid],
                            positions + 1)                  # (T, H, hd)
    y = L.linear_apply(p["o"], out.reshape(1, T, H * hd), cfg, "attn_o",
                       m2)
    return y, {"k": ck, "v": cv}


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
    drops them (``drop_write``). Then attention runs through
    ``paged_flash_decode``: the Hopper kernel on CUDA (the reference gathers
    the pages densely and never calls its Pallas kernel), the plain version
    on the CPU. Padding tokens read slot ``n_slots - 1``'s pages, as the
    reference's clipped gather does; their outputs are discarded by the
    caller.
    """
    H, hd = cfg.n_heads, cfg.hd
    T = x.shape[1]
    k_pool, v_pool = cache["k"], cache["v"]
    P, ps = k_pool.shape[0], k_pool.shape[1]
    n_slots = page_table.shape[0] - 1
    npg = page_table.shape[1]
    q, k, v = _qkv(p, cfg, x, positions)

    slot_ids = slot_ids.long()
    positions = positions.long()
    page_of = page_table.long()[slot_ids.clamp(0, n_slots),
                                (positions // ps).clamp(0, npg - 1)]
    keep = (page_of >= 0) & (page_of < P)
    drop_write(cache, page_of * ps + positions % ps, keep, k[0], v[0])

    sid = slot_ids.clamp(0, n_slots - 1)
    out = paged_flash_decode(q[0], k_pool, v_pool, page_table, sid,
                             positions)                      # (T, H, hd)
    y = L.linear_apply(p["o"], out.reshape(1, T, H * hd), cfg,
                       "attn_o")
    return y, {"k": k_pool, "v": v_pool}
