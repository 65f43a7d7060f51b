"""Decoder trunk over the serving KV caches (port of the dense and MoE
families of ``repro.models.transformer``).

A MoE block's MLP is ``models.moe.moe_apply`` over the block's tokens as
the reference routes them: the packed, paged (packed and window) and
prefill steps route the whole step's tokens together, sentinel padding
included (so a real token's output depends on the bucket it rides in, as
in the reference); the contiguous decode and window steps route each slot
alone (``per_row``), as the reference's engine vmaps them over slots.

The reference's ``lax.scan`` over stacked ``blocks`` becomes a Python loop
over a list of per-layer param dicts. The caches stay stacked over layers
and are written in place: the contiguous cache's K/V are ``(n_layers, B, T,
Hkv, hd)`` with a per-slot ``pos`` (B,) (the reference's natural layout;
its engine vmaps single-slot caches where the port batches the slots), the
paged pools ``(n_layers, P, page_size, Hkv, hd)``. ``init_cache`` and
``init_paged_cache`` allocate each as the view of a buffer with one more
row a layer (``"k_rows"`` / ``"v_rows"``): the scratch row that dropped
writes go to (``attention.drop_write``), which no read addresses.

K/V are stored in ``cfg.kv_dtype``: the model dtype, or int8 under
``kv_cache_dtype="int8"`` (``attention``).

The steps return ``pos`` as a new tensor, as the reference does; a caller
that replays a step as a CUDA graph copies it into its own (the engine).
The legacy engine's prefills (``serve_prefill``, ``serve_prefill_ragged``)
fill a fresh cache of their own and return it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

_FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the port serves the dense and MoE families only so far, got "
            f"{cfg.family!r}")


def _mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
               mids: Optional[torch.Tensor] = None) -> torch.Tensor:
    u = L.linear_apply(p["up"], x, cfg, "mlp_up", mids)
    if cfg.mlp_gated:
        g = L.linear_apply(p["gate"], x, cfg, "mlp_gate", mids)
        h = (torch.nn.functional.silu(g.to(torch.float32))
             * u.to(torch.float32)).to(x.dtype)
    else:
        h = torch.nn.functional.gelu(u.to(torch.float32)).to(x.dtype)
    return L.linear_apply(p["down"], h, cfg, "mlp_down", mids)


def _layer(cache: dict, li: int) -> dict:
    """Layer ``li``'s K/V (and their scratch-row buffers, where allocated)."""
    return {name: t[li] for name, t in cache.items() if name != "pos"}


def _block(p: dict, cfg: ModelConfig, x: torch.Tensor, attn, *,
           per_row: bool = False, **kw) -> torch.Tensor:
    """Pre-norm attention + MLP (or MoE) block; ``attn`` is one of the
    attention functions of ``models.attention`` over the layer's cache,
    called with ``kw``. A ``mids`` entry of ``kw`` ((T,) variant ids of a
    packed stream) reaches the attention's and the MLP's linears.
    ``per_row`` routes a MoE block's rows alone (module docstring)."""
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    y, _ = attn(p["attn"], cfg, h, **kw)
    x = x + y
    h = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        y, _aux = M.moe_apply(p["moe"], cfg, h, per_row=per_row)
        return x + y
    mids = kw.get("mids")
    # mids is (T,); the MLP's activations are (1, T, d)
    return x + _mlp_apply(p["mlp"], cfg, h,
                          None if mids is None else mids[None, :])


def _unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T.to(x.dtype)
    return x @ params["lm_head"]["w"].to(x.dtype)


def cache_shapes(cfg: ModelConfig, B: int, T: int) -> dict[str, tuple]:
    """Shapes of the contiguous serving cache: per-slot K/V buffers of
    length T, stacked over layers, and each slot's fill level."""
    _check_family(cfg)
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.hd)
    return {"k": shape, "v": shape, "pos": (B,)}


def _kv(shapes: dict, dtype, device) -> dict[str, torch.Tensor]:
    """Zero K and V of ``shapes`` ((n_layers, ..., Hkv, hd)), each the view
    of an (n_layers, R + 1, Hkv, hd) buffer (``"k_rows"`` / ``"v_rows"``)
    whose last row a layer is the scratch row of ``drop_write``."""
    out = {}
    for name in ("k", "v"):
        nl, *lead, Hkv, hd = shapes[name]
        R = math.prod(lead)
        rows = torch.zeros((nl, R + 1, Hkv, hd), dtype=dtype, device=device)
        out[name] = rows[:, :R].view(shapes[name])
        out[name + "_rows"] = rows
    return out


def init_cache(cfg: ModelConfig, B: int, T: int, device
               ) -> dict[str, torch.Tensor]:
    """Zero contiguous cache: K/V in ``cfg.kv_dtype`` (with their scratch
    rows), ``pos`` int32."""
    shapes = cache_shapes(cfg, B, T)
    return {**_kv(shapes, cfg.kv_dtype, device),
            "pos": torch.zeros(shapes["pos"], dtype=torch.int32,
                               device=device)}


def _trunk(params: dict, cfg: ModelConfig, cache: dict,
           tokens: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """(B, S) tokens appended at each row's ``cache["pos"]``: features
    (B, S, d), K/V written into the cache in place. ``per_row`` routes a
    MoE block's rows alone (the reference's vmapped steps)."""
    _check_family(cfg)
    S = tokens.shape[1]
    pos0 = cache["pos"].long()
    positions = pos0[:, None] + torch.arange(S, device=tokens.device)[None]
    x = L.embed_apply(params["embed"], tokens)                  # (B, S, d)
    for li, p in enumerate(params["blocks"]):
        x = _block(p, cfg, x, A.attn_apply, per_row=per_row,
                   positions=positions, cache=_layer(cache, li),
                   cache_pos=pos0)
    return x


def serve_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  buffer_len: int) -> tuple[torch.Tensor, dict]:
    """Run (B, Sp) prompts through the model into a fresh cache of
    ``buffer_len``: ((B, vocab) logits at the last position, the cache with
    ``pos`` = Sp)."""
    B, Sp = tokens.shape
    cache = init_cache(cfg, B, buffer_len, tokens.device)
    x = _trunk(params, cfg, cache, tokens)
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    cache["pos"] += Sp
    return logits, cache


def serve_prefill_ragged(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                         buffer_len: int, lengths: torch.Tensor
                         ) -> tuple[torch.Tensor, dict]:
    """Batched prefill of right-padded prompts: row b's prompt in columns
    [0, lengths[b]) of (B, Lb) ``tokens``. Returns the (B, vocab) logits at
    column ``lengths[b] - 1`` (clipped into [0, Lb)), which causal attention
    makes independent of the padding, and a fresh cache of ``buffer_len``
    holding K/V for all Lb columns (padding included) with ``pos`` = Lb;
    the engine re-bases each row's ``pos`` to its true length, and decode
    overwrites each padded position before attending to it."""
    B, Lb = tokens.shape
    cache = init_cache(cfg, B, buffer_len, tokens.device)
    x = _trunk(params, cfg, cache, tokens)
    col = (lengths.long() - 1).clamp(0, Lb - 1)
    feats = x[torch.arange(B, device=x.device), col]            # (B, d)
    logits = _unembed(params, cfg, feats[None])[0]
    cache["pos"] += Lb
    return logits, cache


def serve_step(params: dict, cfg: ModelConfig, cache: dict,
               tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B, 1) -> ((B, vocab) logits, the cache with
    every row's ``pos`` advanced by one). A MoE block routes each row
    alone, as the reference's engine vmaps this step over its slots."""
    x = _trunk(params, cfg, cache, tokens, per_row=True)
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + 1
    return logits, new_cache


def serve_step_window(params: dict, cfg: ModelConfig, cache: dict,
                      tokens: torch.Tensor, n_valid: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """Ragged window: row b advances by ``n_valid[b]`` of its W supplied
    tokens ((B, W), real tokens in columns [0, n_valid[b])). Returns the
    (B, vocab) logits at column ``n_valid[b] - 1`` (clamped into [0, W)),
    unembedding only those B rows, and the cache with ``pos += n_valid``.
    The padded K/V written past a row's true tokens sit beyond every query
    position until real tokens overwrite them; the engine over-allocates
    the buffer by W so that the writes never clamp for a live slot. A MoE
    block routes each row alone, as the reference's engine vmaps this step
    over its slots."""
    W = tokens.shape[1]
    x = _trunk(params, cfg, cache, tokens, per_row=True)
    col = (n_valid.long() - 1).clamp(0, W - 1)
    feats = x[torch.arange(x.shape[0], device=x.device), col]   # (B, d)
    logits = _unembed(params, cfg, feats[None])[0]
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + n_valid.to(cache["pos"].dtype)
    return logits, new_cache


def _packed_trunk(params: dict, cfg: ModelConfig, cache: dict,
                  tokens: torch.Tensor, new_pos: torch.Tensor,
                  emit_idx: torch.Tensor, attn, **kw
                  ) -> tuple[torch.Tensor, dict]:
    """One dense pass over a packed (T,) token stream, ``attn`` reading and
    writing each layer's cache; the unembed runs on the B rows at
    ``emit_idx`` only."""
    _check_family(cfg)
    x = L.embed_apply(params["embed"], tokens[None])           # (1, T, d)
    for li, p in enumerate(params["blocks"]):
        x = _block(p, cfg, x, attn, cache=_layer(cache, li), **kw)
    feats = x[0][emit_idx.long()]                               # (B, d)
    logits = _unembed(params, cfg, feats[None])[0]              # (B, vocab)
    new_cache = dict(cache)
    new_cache["pos"] = new_pos
    return logits, new_cache


def serve_step_packed(params: dict, cfg: ModelConfig, cache: dict,
                      tokens: torch.Tensor, slot_ids: torch.Tensor,
                      positions: torch.Tensor, new_pos: torch.Tensor,
                      emit_idx: torch.Tensor, *,
                      model_ids: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, dict]:
    """Token-packed step against the contiguous cache: the contract of
    ``serve_step_paged`` without the page table (padding tokens carry
    ``slot_id == B``). Returns ((B, vocab) logits gathered at ``emit_idx``
    before the unembed, the cache with ``pos`` set to ``new_pos``).
    ``model_ids`` (B,) maps each slot to a stacked-alpha variant
    (``serve_step_packed_multi``); None = one model."""
    kw = {}
    if model_ids is not None:
        # padding tokens (slot_id == B) clip to slot B - 1: their variant
        # is arbitrary, their writes dropped and their outputs discarded
        B = model_ids.shape[0]
        kw["mids"] = model_ids[slot_ids.long().clamp(0, B - 1)]
    return _packed_trunk(params, cfg, cache, tokens, new_pos, emit_idx,
                         A.attn_apply_packed, slot_ids=slot_ids,
                         positions=positions, **kw)


def paged_cache_shapes(cfg: ModelConfig, page_size: int, n_pages: int
                       ) -> dict[str, tuple]:
    """Shapes of the paged serving cache: per-layer K/V page pools shared by
    every slot, stacked over layers."""
    _check_family(cfg)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k": shape, "v": shape}


def init_paged_cache(cfg: ModelConfig, page_size: int, n_pages: int,
                     device) -> dict[str, torch.Tensor]:
    """Zero page pools in ``cfg.kv_dtype``, with their scratch rows."""
    return _kv(paged_cache_shapes(cfg, page_size, n_pages), cfg.kv_dtype,
               device)


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
    return _packed_trunk(params, cfg, cache, tokens, new_pos, emit_idx,
                         A.attn_apply_paged, slot_ids=slot_ids,
                         positions=positions, page_table=page_table)


def serve_step_window_paged(params: dict, cfg: ModelConfig, cache: dict,
                            page_table: torch.Tensor, tokens: torch.Tensor,
                            n_valid: torch.Tensor
                            ) -> tuple[torch.Tensor, dict]:
    """Advance slot b by ``n_valid[b]`` of its W supplied tokens ((B, W)
    window), returning each slot's logits at column ``n_valid[b] - 1``: the
    window is flattened onto ``serve_step_paged``; padding columns become
    sentinel-slot tokens at position 0. ``cache["pos"]`` is (B,)."""
    tok, slot_ids, positions, new_pos, emit_idx = _window_as_packed(
        cache, tokens, n_valid)
    return serve_step_paged(params, cfg, cache, page_table, tok, slot_ids,
                            positions, new_pos, emit_idx)


# ---------------------------------------------------------------------------
# Multi-model steps: same-architecture variants batched in one step
# ---------------------------------------------------------------------------

def serve_step_packed_multi(params: dict, cfg: ModelConfig, cache: dict,
                            tokens: torch.Tensor, slot_ids: torch.Tensor,
                            positions: torch.Tensor, new_pos: torch.Tensor,
                            emit_idx: torch.Tensor, model_ids: torch.Tensor
                            ) -> tuple[torch.Tensor, dict]:
    """``serve_step_packed`` over M stacked same-architecture variants.

    ``params``' OVSF alpha leaves carry a leading (M, ...) variant axis
    (every other leaf, ids included, is shared: ``serving.model_registry.
    stack_variants``); ``model_ids`` (B,) maps each slot to its variant,
    and each packed token contracts against its slot's alpha bank
    (``kernels.ops.ovsf_matmul_multi``), so a step mixes models at the
    single-model step shapes."""
    if cfg.family == "moe":
        raise NotImplementedError(
            "multi-model batching over MoE expert banks is not supported "
            "yet (per-expert alpha stacking)")
    return serve_step_packed(params, cfg, cache, tokens, slot_ids, positions,
                             new_pos, emit_idx, model_ids=model_ids)


def _window_as_packed(cache: dict, tokens: torch.Tensor,
                      n_valid: torch.Tensor) -> tuple:
    """A (B, W) ragged window flattened onto the packed layout: padding
    columns (``col >= n_valid[b]``) become sentinel-slot tokens at position
    0; each slot emits at its column ``n_valid[b] - 1``. ``cache["pos"]``
    is (B,)."""
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
    return tokens.reshape(-1), slot_ids, positions, new_pos, emit_idx


def serve_step_window_multi(params: dict, cfg: ModelConfig, cache: dict,
                            tokens: torch.Tensor, n_valid: torch.Tensor,
                            model_ids: torch.Tensor
                            ) -> tuple[torch.Tensor, dict]:
    """``serve_step_window`` semantics over stacked variants: slot b
    advances by ``n_valid[b]`` of its W tokens under variant
    ``model_ids[b]``, the window flattened onto the packed multi trunk as
    ``serve_step_window_paged`` flattens it onto the paged one (exact
    writes, no window slack). ``cache["pos"]`` is (B,)."""
    tok, slot_ids, positions, new_pos, emit_idx = _window_as_packed(
        cache, tokens, n_valid)
    return serve_step_packed_multi(params, cfg, cache, tok, slot_ids,
                                   positions, new_pos, emit_idx, model_ids)
